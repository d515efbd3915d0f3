#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line; each
1080p path's stream must also have the byte count STREAM_BYTES gives it):
  1. print the card's name and power limit; build the CUDA kernels from
     the thirteen sources in h264_fer_tpu_torch/kernels/csrc (one nvcc per
     source, sm_90a) and the native slice decoder
     h264_fer_tpu_torch/native/decoder_native.cpp (g++), all started at
     once, and print each build's time and compiler report;
  2. hold the K1 kernel and K1t (K1 writing its levels), one dataflow
     launch per frame, against their plain PyTorch versions on the card:
     bit-exact recon (and K1t's four level arrays) at 1920x1088 for QP 8,
     28 and 46 on structured content made from a seed, on two small grids
     (wide and tall), on QCIF and 64x208 with the grid forced to 1 and to 3
     blocks, on a one-MB-wide 16x144 and a one-MB-tall 176x16 frame, and on
     random modes, with K1t's recon equal to K1's; time them with CUDA
     events, holding every timed call to the plain output. K1 lies on no
     encode path since K1t replaced it: its path is one i16_recon call at
     1080p, counted (one launch);
  3. drive the all-intra path: GopIntraEncoder encodes 8 frames at
     1920x1088, QP 28, on the card with the launch counts set to 0 just
     before (one K1t launch, one K10 launch and one K11 I16-form launch
     per frame, no K1); the stream must equal, byte for byte, the stream of
     the plain chain (plain mode decision, plain K1t, plain entropy) on the
     card, and parse back into
     SPS, PPS and 8 IDR slices; the QCIF stream of the 10 frames of
     tests/fixtures/clip_qcif_10f.y4m at QP 28 from the card must equal the
     CPU path's and have the SHA-256 DEVICE_DIGESTS gives it (the JAX
     GopIntraEncoder's stream, recomputed by tests/test_torch_iframe.py).
     The encoder replays its frame program, a CUDA graph captured in the
     warm-up (codec/program.py), once a frame. Prints e2e fps, device
     frame fps, the per-stage device times, the busy share of its replays
     (CUDA events around each; no profiler over graph replays) and
     the program's capture time, beside one run of the same encoder
     issuing its launches eagerly (eager_programs()): its e2e fps and busy
     share;
  4. hold K13 (the 16 interpolated planes, one launch a reference), K2
     (integer search: the map in MB-quadrant order and the argmin in one
     launch, as the P frame takes them, and its block-order form on the
     same inputs), K3 (qpel refine), K4 (P decision
     wavefront, one
     launch per frame), K5 (MC, one thread per quadrant row reading aligned
     words) and K12 (the P residual / recon, one launch a frame) against
     their plain twins on the card, bit-exact: at 1920x1088 for QP 28, 40
     and 46 (the three metric tiers) on the maps and MVs of a content pair,
     then on QCIF grids with random previous MVs beyond the search limit,
     random MC MVs over the whole ±limit (K4 also with its grid forced to 1
     and to 3 blocks), and flat content where every score ties, the random
     MVs again at window 7 (luma rows W + 18 bytes, only 2-byte aligned),
     and on a tall 64x208, a one-MB-wide 16x144 and a one-MB-tall 176x16
     content pair; K12 also on a 1080p P frame's decided inputs with the
     prefilter on and off at MAXDIFF 3 and 255, every MB skipped and none,
     and prediction 0 against source 255 and the reverse at QP 28, 40 and
     46; K13 also on a 0/255 checkerboard reference (its 6-taps clip) at
     windows 8 and 7, frame and band 1 of 4 (check_k12_k13); K2 also in
     both forms and every metric on QCIF at ext 10, 1080p at window 7 / ext 9,
     at ext = window and flat, windows 0, 4, 12 and 17 and a 40x24 grid
     (check_k2_shapes); time kernel and plain at QP 28, holding every
     timed call to the plain output, and K2's one launch beside its block
     map with the eager argmin and blocks_to_mbq it replaced;
  5. drive the IPPP main path: GopIpppEncoder(1920, 1088, 28, gop_len=8)
     encodes 16 frames with the launch counts set to 0 just before; the
     stream of the first GOP's first 4 frames (the IDR and 3 P frames) must
     equal, byte for byte, the stream of the plain chain on the card (the
     plain decision, plain K1, all four plain P twins and the plain
     entropy), and the whole
     stream parse back into SPS, PPS and per GOP an IDR and 7 P slice
     headers; the QCIF IPPP stream of the clip's first 6 frames (GOP 4, QP
     28) from the card must equal the CPU path's and have its
     DEVICE_DIGESTS digest (tests/test_torch_ippp.py). Prints e2e fps,
     device ms per P frame for each stage and the counted launches (one
     K1t and one K11 I16 form per IDR, one K13, K2, K3, K4, K5 and K12
     per P frame, one K10 per frame); each GOP is one replay of its GOP
     program; the eager run beside it, as in phase 3;
  6. hold K4x4 (Intra_4x4 recon and levels), K7 (chroma wavefront writing
     its levels) and K6 (mixed arbitration wavefront), each one dataflow
     launch per frame, against their plain twins on the card, bit-exact on
     every output (K7: recon planes and both level arrays from
     chroma_frame, and the recon planes from chroma_recon): at 1920x1088
     for QP 8, 28 and 46 in the decided modes of a content frame (printing
     the I4x4 MB count of each K6 check; at QP 28 it must lie strictly
     between 0 and the MB count), on QCIF, 80x176, one-MB-wide 16x176 and
     one-MB-tall 176x16 grids with random Intra4x4 modes in every block (on
     QCIF, 16x176 and 176x16 all three also with their grids forced to 1
     and to 3 blocks), and on a tall 64x208 grid (hmb > wmb) where both
     classes win (grids forced likewise). K4x4 lies on no encode path, as
     its Pallas original: its path is one i4x4_luma call on the 1080p frame
     at QP 28, with its count set to 0 just before (one launch). Times
     kernels and plain twins at QP 28, holding every timed call to the
     plain output;
  7. drive the mixed all-intra path: GopIntraEncoder(1920, 1088, 28,
     mode="mixed") encodes 8 frames with the launch counts set to 0 just
     before (one K6, one K7 and one K11 full-form launch per frame, one
     K10 launch of the chroma setup, computed once a frame, and one of the
     slice, no K1 or K1t, and no rebuild of the chroma levels from the
     recon); the first
     frame's stream must equal, byte for byte, the stream of the plain
     chain on the card, and the whole stream parse back; the QCIF mixed
     stream of the clip's first 2 frames at QP 28 from the card must equal
     the CPU path's and have its DEVICE_DIGESTS digest
     (tests/test_torch_mixed.py). Prints e2e fps, device ms of each stage
     of one frame and the replays' busy share, through the frame program,
     and the eager run beside it, as in phase 3;
  8. hold K8 (the in-loop filter, one dataflow launch per frame) against
     its plain twin on the card, bit-exact: at 1920x1088 on an I frame's
     state at QP 16, 28 and 46 and on a P frame's state at QP 28, 36 and 46
     (the session encoder's, after an IDR), then with random state (every
     bS 0-4) on QCIF and 64x208, each also with the grid forced to 1 and to
     3 blocks, and on a one-MB-wide 16x144 and a one-MB-tall 176x16 frame;
     time kernel and plain at QP 28 on the P state, holding every timed
     call to the plain output, where the bound counts the filter's
     operations only on the lines that pass its alpha / beta test;
  9. drive the session path: Encoder(1920, 1088, EncoderConfig(qp=28,
     intra_every=8, deblock=True)) encodes 16 frames with the launch counts
     set to 0 just before (one K1t and one K11 I16-form launch per IDR,
     one K8 launch per frame, one launch of each P kernel, K13 and K12
     among them, per P frame, one K10 per frame); the first 3 frames'
     stream must equal, byte for byte, the plain chain's (the same encoder
     with every kernel, K10-K13 among them, swapped for its plain twin,
     none of them launching), and the stream
     parse back with the filter signalled in the PPS
     and every slice header; QCIF session streams from the card, with i16
     IDRs and with mixed IDRs, must equal the CPU path's, and the i16 one
     (the clip's 10 frames, QP 30, intra_every 4, deblock) have its
     DEVICE_DIGESTS digest (tests/test_torch_encoder.py). Prints e2e fps,
     K8's ms and launches per frame, the session's stage times (one
     replay of the IDR and of the P frame program) and the replays' busy
     share, and the eager run beside it, as in phase 3;
  10. drive the host path, the reference encoder's exact per-MB loop on the
     host with the in-loop filter K8 on the card: Encoder(1920, 1088,
     EncoderConfig(qp=28, intra_every=8, deblock=True), iframe="host",
     pframe="host") encodes 2 frames (an IDR and a P frame) with K8's,
     K11's, K12's and K13's counts set to 0 just before (one K8 launch per
     frame, one K13 per P frame for the planes its search reads, no K11,
     no K12);
     the stream must
     parse back with the filter signalled, and K8 is held bit-exact against
     its plain twin on the last P frame's state before its filter. Prints
     the seconds per frame of the host loop and of K8's synchronised call,
     and the run's e2e fps. On QCIF, on the card and on the CPU: the
     all-intra stream at QP 28 on 3 frames of tests/fixtures/clip_qcif_10f
     .y4m must be the prefix of tests/fixtures/ref_qcif_intra_qp28.264 (the
     C++ reference encoder's bytes), and each HOST_QCIF stream (5 frames of
     the clip) must have the SHA-256 HOST_DIGESTS gives it, the digest of
     the JAX package's host Encoder's stream (tests/test_torch_host_encoder
     .py recomputes them with JAX; three of them with me="topk", the JAX
     Encoder's TpuMePipeline); each card stream must equal the CPU's, and
     the device-modes stream on the card take one K11 full-form launch per
     IDR (none on the CPU, none in the other streams).
     Then the --tpu-me path: hold K2 (SAD, ext = window) + K9 (the stable
     top-16 selection) bit-exact against their plain chain on the card
     (ops/me.full_search_topk) on QCIF, 64x208, a flat 1080p pair where
     every SAD ties and the 1080p P frame's own source and reference as
     the path below recorded them, and K9 alone on random maps at windows
     0-17 (each of its instances) and on adversarial rows (k9_rows: the
     32-bit keys' range limit and a step above, rows of one value, the
     least scores in one lane), rows of both key forms; drive
     Encoder(1920, 1088, EncoderConfig(qp=28, intra_every=8,
     deblock=True), iframe="i16", pframe="host", me="topk") (the CLI's
     `encode --tpu-iframe --tpu-me --deblock --intra-every 8`) on 2
     frames with the launch counts set to 0 just before (one K1t, K2, K9
     and K13 launch, one K10 and one K11 I16 form for the IDR, one K8 per
     frame, no other P kernel and no K10 on the host P frame): the stream parses
     with the filter signalled and its candidates, read from plane 0 of
     the P frame's interpolated planes, equal the plain chain's. Times K9
     both ways on that P frame's map, its plain twin and one torch.topk
     call as the library's yardstick (timed only), and prints the P
     frame's host seconds beside the full-search host P frame's;
  11. the multi-device encoders and the band kernels: hold K1t-band,
     K7-band and K6-band against their plain twins, bit-exact, on band 1 of
     4 of a 1080p frame at QP 8, 28 and 46 with a real halo (band 0's last
     rows as the full-frame kernels leave them), each also equal to the
     full-frame kernel's rows of the band, timing them at QP 28; then drive
     the multi-device encoders at 1080p on entries of the one card (and on
     cuda:0..n-1 where there are n cards): TileIntraEncoder all-I16 in 4
     even and 3 uneven bands and mixed in 3 uneven bands,
     GopTileIntraEncoder (2, 2), GopIntraEncoder and GopIpppEncoder on 2
     entries, each with the band kernels' counts set to 0 just before (one
     launch of each band kernel of its mode per band per frame, and K10's
     one per slice or band, one more per band for the mixed chroma
     setup, and K11's one per band or frame, in the form of its mode);
     every
     stream must equal the one-device stream of phase 3, 5 or 7, and the
     band encoders' recon must decode from it (decode_gate, untimed).
     Prints each one's median e2e fps of 3 after a warm-up, the profiled
     busy share of 2 frames in 4 bands, the device ms of each stage of one
     band (i16 and mixed) and measure_scaling at 1, 2 and 4 entries; the
     QCIF band streams on the
     card (3 frames of the clip, i16 in 3 bands and mixed in 2) must have
     the SHA-256 TILE_DIGESTS gives them (the JAX TileIntraEncoder's
     streams, recomputed by tests/test_torch_tile_jax.py); two processes
     (torch.distributed, gloo) encode QCIF GOPs of 2 on the card through
     parallel/dist.py, and process 0's stream must equal the one-process
     stream;
  12. the P-frame bands: hold K4-band (the P decision wavefront over one
     band of MB rows, one launch) against its plain twin, bit-exact, on
     band 1 of 4 of the 1080p IPPP content pair (phase 4's chained pair) at
     QP 28, 40 and 46 with a real halo (the frame K4's last MB row of band
     0), and on QCIF in 3 bands with random previous MVs beyond the search
     limit (also with its grid forced to 1 and to 3 blocks); K13's band
     form (from the band's rows between real rows of its neighbours), K2,
     K3, K4-band, K5 and K12 on the band's inputs, each held to its plain
     twin, must also equal the frame kernels' rows of the band;
     time K4-band at QP 28, holding every timed call to the plain output,
     and print the device ms of each stage of that band's P frame. Then
     drive TileIpppEncoder(1920, 1088, 28, gop_len=8) in 4 bands of 17 MB
     rows and in 2 of 34, and GopTileIpppEncoder (2, 2), on entries of the
     card, each with the launch counts set to 0 just before (one K13, K2,
     K3, K4-band, K5 and K12 launch per band per P frame, one K1t-band and
     one K11 I16 form per band per IDR, one K10 per band, no frame K4 or
     K1t):
     each stream must equal
     phase 5's one-device
     stream and the bands' reference planes decode from it (decode_gate,
     spec mode, untimed); prints each one's median e2e fps of 3 after a
     warm-up. The QCIF band streams on the card (6 frames of the clip, GOP
     4, 3 bands, QP 28 and 40) must have the SHA-256 TILE_P_DIGESTS gives
     them (the JAX GopIpppEncoder's streams, recomputed by
     tests/test_torch_ippp.py);
  13. hold K10 (the slice entropy, one launch a slice or band; the
     chroma setup, one) against its plain twins on the card, bit-exact on
     every output key (the words in full): all-I16, mixed, P and the chroma
     setup at 1920x1088 for QP 8, 28 and 46 on the levels and decisions of
     a content frame (K1t, K7 and K6, K2-K5 on phase 4's content pair); the
     band forms on band 1 of 4 at QP 28 with a real top_ctx (band 0's last
     MB row of the frame's state), padded MBs (`valid` False on the band's
     last MB row) and P's run_lead as a tensor on the card; and on QCIF,
     64x208, 16x144 and 176x16 grids with seeded random levels that reach
     every branch (k10_levels: both level escapes, suffixLength 6, 16 of 16
     and 15 of 15 nonzeros, three trailing ones with more than 10 nonzeros,
     zerosLeft > 6, every nC context), every P mb_type with extreme mvds,
     an all-skip P frame, P frames whose last and whose first MB is
     skipped, as whole slices and as bands (top_ctx, valid, run_lead an int
     and a tensor); and the 1080p QP 28 P frame with whole tickets of MBs
     skipped (more than a look-back window of them in a row), as a slice
     and as band 1 of 4. Times each form both ways at 1080p QP 28 beside its
     plain twin, holding every timed call to the plain output, and the
     fill of its workspace alone;
  14. hold K11 (the intra mode decision, one launch a frame or band) in
     its I16 and full forms against their plain twins on the card,
     bit-exact on mode16, satd16, mode4 and satd4, on the uint8 plane and
     on it as int32: 1920x1088 content at QP 8, 28 and 46; band 1 of 4
     with the source row above as top_row (QP 8, 28, 46) and with that row
     holding -1 entries; seeded uniform-random frames (QP 8, 28, 46); flat
     frames of 0, 128 and 255, where every mode ties and the gates and the
     first-min order decide; vertical and horizontal stripes; and the
     16x16, 176x144, 80x176, 16x144 and 176x16 grids (content, random at
     QP 0 and 51, flat 255). Times both forms at 1080p QP 28 beside the
     plain twins, holding every timed call to the plain output;
  15. the decode gate: decode each 1080p stream of phases 3, 5, 7, 9 and 10
     (both of phase 10's)
     with the port's Decoder on the card (native form) and hold every
     frame, exactly, to the reconstruction the run has for it: the plain
     chain's recon (all-intra), the kernel path's reference planes as the
     encoders recorded them (IPPP, mixed) and the session encoder's
     reference planes (session, host and --tpu-me, filter on: K8 runs once per
     decoded frame). IPPP and mixed decode in the spec-correct mode (zero chroma
     AC where a MB has no residual, as the encoders reconstruct); the
     session stream selects it by signalling the filter. Prints each
     stream's frames, median decode fps of 5 runs after a warm-up and K8
     launches per frame; the QCIF session streams decode equal on the
     card and on the CPU (plain K8);
  16. the device programs (codec/program.py) against the eager launches
     of the same kernels on the card, in every output: the whole-GOP IPPP
     program of 8 frames and of a short last GOP of 3 (payload words and
     nbits, every frame's reference planes, the final planes and MVs),
     the I16 and the mixed frame programs (every output of the frame
     function), each replayed twice on different 1080p frames, the first
     replay's copied payloads held again after the second; the session's
     IDR and P frame programs (intra_every 3, the filter on: the NAL
     bytes and the state after each of 5 frames, IDR, P, P, IDR, P); each
     program's captured launches equal to the eager run's; and two lanes
     of the card replaying at once (GopIpppEncoder and GopIntraEncoder on
     ["cuda:0"] * 2) against one eager lane: streams and every frame's
     reference planes. Prints each program's capture time;
  17. print the kernels line (K8's row also with its launches on the host
     path and on the session stream's decode, K2's with its launches on
     the --tpu-me path, K9's with torch.topk's time as library_ms, K12's
     and K13's with their launches on the P-band paths and K13's on the
     host and --tpu-me paths) and, last,
     {"ok": true, "device": {...}}.
     Each kernel's time is taken two ways (kernel_ms): `ms` with its
     calls issued as the host gets to them, as a path issues them, and
     `queued_ms` with them queued ahead of the card, the device's own time
     (behind a spin that is doubled until it outlasts the host's issue).

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np

W, H, QP, N_FRAMES = 1920, 1088, 28, 8
E2E_REPS = 5
CHECK_QPS = (8, 28, 46)
SEED = 7
KERNEL_SOURCES = ("wavefront_i16", "me_int", "me_qpel", "wavefront_p", "mc",
                  "wavefront_i4x4", "wavefront_mixed", "deblock", "me_topk",
                  "cavlc_slice", "mode_decision", "residual_p", "interp")
NATIVE_DECODER = "decoder_native"  # h264_fer_tpu_torch/native, built by g++
# the IPPP main path: bench.py's e2e_ippp_encode_1080p_fps configuration
GOP_LEN, N_IPPP, WINDOW = 8, 16, 8
N_PLAIN_IPPP = 4  # frames of the first GOP held against the plain chain
# the session path: 16 frames, an IDR every 8, the in-loop filter on
N_SESSION, SESSION_INTRA_EVERY, N_PLAIN_SESSION = 16, 8, 3
K8_I_QPS, K8_P_QPS = (16, 28, 46), (28, 36, 46)
# the host path: an IDR and a P frame at 1080p (tens of seconds of host work
# each; 3 frames until the multi-device phase took the time)
N_HOST = 2
# the host path's QCIF streams: 5 frames of the clip through
# Encoder(iframe="host", pframe="host", **kwargs) with EncoderConfig(**cfg),
# each held to the SHA-256 of the JAX host Encoder's stream (tpu_* off; for
# device_modes, fed the port's intra_mode_decision; for me="topk", with
# tpu_me=TpuMePipeline(window=8), the CLI's --tpu-me), which
# tests/test_torch_host_encoder.py recomputes
HOST_CLIP = "tests/fixtures/clip_qcif_10f.y4m"
HOST_REF = "tests/fixtures/ref_qcif_intra_qp28.264"  # the C++ reference's bytes
N_HOST_QCIF = 5
HOST_QCIF = {"qp28": ({"qp": 28}, {}),
             "qp40": ({"qp": 40}, {}),
             "qp28_deblock": ({"qp": 28, "deblock": True}, {}),
             "qp28_device_modes": ({"qp": 28}, {"device_modes": True}),
             "qp28_me_topk": ({"qp": 28}, {"me": "topk"}),
             "qp40_me_topk": ({"qp": 40}, {"me": "topk"}),
             "qp28_every3_deblock_me_topk": ({"qp": 28, "intra_every": 3, "deblock": True},
                                             {"me": "topk"})}
HOST_DIGESTS = {
    "qp28": "f3b260b2a7f4f6c86f00d8b41b2c93fa31187face12c60e734925a5a15e21cf8",
    "qp40": "c3460d01d9e2002775b8516c6f48da5480f22307ae5a89b0bd0a450af9d8485d",
    "qp28_deblock": "e34020ea00b5575cd8d6a56702d129d4710c9cd76b72ef02334af34d4c2f1443",
    "qp28_device_modes": "3954d4c2cec9f42df22c0e814a6b6f1b774950e421d9b742eeb1510c1c42ac03",
    "qp28_me_topk": "9c887769442af15c8e86212a4ab02abd83121e08b43e6b6b3784b357c3791f87",
    "qp40_me_topk": "eb2ec348594fd53e6082c1cacea2d9d5559fc3adc16fd361029351b76a418cbc",
    "qp28_every3_deblock_me_topk":
        "17aea80cdadb993a4e9712468a388fadb3592c002c519b9a734296c219e7f02b",
}
# the band encoders' QCIF streams: 3 frames of the clip at QP 28 through
# TileIntraEncoder(mode, n bands), each held to the SHA-256 of the JAX
# TileIntraEncoder's stream, which tests/test_torch_tile_jax.py recomputes
N_TILE_QCIF = 3
TILE_QCIF = {"i16_3": ("i16", 3), "mixed_2": ("mixed", 2)}
TILE_DIGESTS = {
    "i16_3": "f31105fa34311b542483a57adcf9ed75e7c84bf23467d571cea9047b62b8e931",
    "mixed_2": "1e3983a1ec842e6a794152db46bb58186c33e0ce43cba13776f5d2f9da7f0a8d",
}
# the P-band encoder's QCIF streams: 6 frames of the clip through
# TileIpppEncoder(qp, gop_len=4) in 3 bands (two GOPs, the last short), each
# held to the SHA-256 of the JAX GopIpppEncoder's stream of the same frames,
# which tests/test_torch_ippp.py recomputes
N_TILE_P_QCIF = 6
TILE_P_DIGESTS = {
    "qp28": "849523586fe581a5c096d44528bb2b800de772219668d3e77e68be20578e46f5",
    "qp40": "eb5b872a43e6acbf4f1b6fb11f130acea1d54084238298810aa5f0c192466bc0",
}
# the one-device QCIF streams of phases 3, 5, 7 and 9 on the card, each
# held to the SHA-256 of the JAX package's stream of the same configuration
# (the clip's frames: all-intra GopIntraEncoder QP 28, 10 frames; IPPP
# GopIpppEncoder QP 28 GOP 4, 6 frames; mixed GopIntraEncoder(mode="mixed")
# QP 28, 2 frames; session Encoder QP 30 intra_every 4 deblock, 10 frames),
# which tests/test_torch_iframe.py, test_torch_ippp.py, test_torch_mixed.py
# and test_torch_encoder.py recompute with JAX
DEVICE_DIGESTS = {
    "all-intra": "94dd9f5dcac8c2d55b41d34627b18593c27fe64bdd20dcd08ddf84cdf48a89b0",
    "IPPP": "849523586fe581a5c096d44528bb2b800de772219668d3e77e68be20578e46f5",
    "mixed": "59b61c94414a450880e26f3e4e3622f1924ee4ee48fea9fd9e17e80a6443168b",
    "session": "adb8099e36443387ea4f82ab11f591d3ae1ca2066e2f9f9f097f30901b6a27e7",
}
P_QPS = (28, 40, 46)  # SAD, SSD and 2*SSD tiers
# bytes of each 1080p path's stream on chip_smoke's content (the first four
# unchanged since the session path was added; host_me_topk, the --tpu-me
# path's 2 frames, since it was; the kernels and plain twins are
# bit-exact, so a kernel redesign must leave them so)
STREAM_BYTES = {"all-intra": 3_227_147, "IPPP": 7_478_701, "mixed": 3_202_684,
                "session": 7_081_712, "host_me_topk": 844_436}
SMALL = [("176x144", 176, 144), ("80x176", 80, 176)]  # phases 2 and 6's small frames
# H100 SXM at 700 W: HBM3 rate (data sheet), and the int32 rate of the CUDA
# cores: 132 SMs x 128 lanes a clock x 1.98 GHz boost, the SM's issue rate
# (4 schedulers x 32 lanes), which int32 work reaches with IMAD and dp4a on
# the FMA pipe beside the 64 INT32 lanes, as the fp32 peak counts 128 lanes
# a clock (K11's full form runs above the 64-lane rate on the card); K1's
# work is int32.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9


def content(n: int, w: int, h: int, seed: int = SEED):
    """Structured frames (gradients + texture, as bench.py's), from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        y = (((xx // 7 + yy // 5 + 3 * i) % 200)
             + rng.integers(0, 12, (h, w))).astype(np.uint8)
        cb = rng.integers(100, 140, (h // 2, w // 2)).astype(np.uint8)
        cr = rng.integers(100, 140, (h // 2, w // 2)).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# cycles the card spins per timed call before cuda_ms's queued calls (0.1
# ms at 1.98 GHz): time for the host to issue them all first; doubled up to
# QUEUE_DOUBLINGS times while the host's issue outlasts it
QUEUE_CYCLES_PER_REP = 198_000
QUEUE_DOUBLINGS = 6


def cuda_ms(torch, fn, reps: int, check=None, queued=False) -> float:
    """Mean device time of fn() in ms over `reps` calls after one warm-up,
    timed with CUDA events. Without `queued` (stage times, a kernel's ms)
    the events also count the card waiting for the host. With `queued` (a
    kernel's queued_ms) the timed calls wait behind a kernel that spins the
    card (torch.cuda._sleep) while the host issues them, so the events time
    the device's work back to back, not the host's pace of issuing it: a
    wrapper's own host time can exceed a short kernel's device time. The
    spin must outlast the issue: if the start event has passed when the
    last call is issued, the round is timed again with twice the spin
    (AssertionError after QUEUE_DOUBLINGS doublings). With `check`, every
    call's output is passed to check(), a timed round's kept until the
    round's end, so that a race shows as a mismatch in any repetition; an
    untimed round of `reps` calls, kept and checked the same way, first
    grows the allocator's cache to hold them, so that no device allocation
    for the kept outputs lands in the timed round."""
    first = fn()
    if check is not None:
        check(first)
        for out in [fn() for _ in range(reps)]:
            check(out)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = QUEUE_CYCLES_PER_REP * reps
    for doubling in range(QUEUE_DOUBLINGS + 1):
        outs = []
        torch.cuda.synchronize()
        if queued:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            out = fn()
            if check is not None:
                outs.append(out)
        covered = not (queued and start.query())
        end.record()
        torch.cuda.synchronize()
        for out in outs:
            check(out)
        if covered:
            return start.elapsed_time(end) / reps
        print(f"queued timing: a spin of {cycles} cycles ended before the host had issued "
              f"{reps} calls; again with {2 * cycles}", flush=True)
        cycles *= 2
    raise AssertionError(f"queued timing: the host's issue of {reps} calls outlasted a spin "
                         f"of {cycles // 2} cycles")


def kernel_ms(torch, fn, reps: int, check=None):
    """A kernel's time two ways, (ms, queued_ms), each by cuda_ms: ms with
    the calls issued as the host gets to them (the kernels line's `ms`, the
    method it has always used: what a path sees), queued_ms with the calls
    queued ahead of the card (the device's own time, which the host's pace
    can hide for a kernel shorter than its wrapper's host time)."""
    return (cuda_ms(torch, fn, reps, check),
            cuda_ms(torch, fn, reps, check, queued=True))


def k1_pixel_ops(qp: int) -> float:
    """int32 operations per reconstructed sample that K1's function needs
    at this QP, in its minimal form, outside prediction and the DC path."""
    # ((d << s) - adj) * lq + 2^14 >> 15, or (d >> s) * lq + 2^14 >> 15
    quant = 5 if qp < 24 else 4
    # (c * ls + rnd) >> s, or (c * ls) << s
    dequant = 3 if qp < 24 else 2
    return (1 + 3          # residual; the reference's h = d ? 64 d - 32 : 0
            + 2 * 22 / 4   # forward core transform: per pass and 4 outputs, 4
                           # butterfly adds, 2 x (add, scale, +512, >>10),
                           # 2 x (2 mul, add, +512, >>10)
            + 15 / 16 * (quant + dequant)  # the 15 AC coefficients of 16
            + 2 * 10 / 4   # inverse core transform: per pass and 4 outputs,
                           # 4 adds, 2 shifts, 4 adds
            + 5)           # +32, >>6, +pred, clip (min, max)


def i16_luma_ops(qp: int, m16: np.ndarray) -> float:
    """int32 operations of the Intra16x16 luma coding of MBs in modes m16:
    butterflies for every transform, each value computed once."""
    luma_dc = 16 * (2 * 2 + 2 + (5 if qp < 36 else 4)  # 4x4 Hadamard, round,
                    + 2 * 2 + (3 if qp < 36 else 2))   # quant; inverse, scale
    # prediction: V and H copy; DC sums its 32 samples; Plane needs its
    # gradients per MB and an add, a shift and a clip per sample
    luma_pred = (np.count_nonzero(m16 == 2) * 36
                 + np.count_nonzero(m16 == 3) * (54 + 4 * 256))
    return m16.size * (256 * k1_pixel_ops(qp) + luma_dc) + luma_pred


def chroma_ops(qpc: int, cm: np.ndarray) -> float:
    """int32 operations of the intra chroma coding of MBs in chroma modes
    cm (K7's function, K1's chroma half)."""
    chroma_dc = 4 * (2 + 2 + 5 + 2 + 3)  # 2x2 Hadamard, round, quant, inverse, scale
    chroma_pred = 2 * (np.count_nonzero(cm == 0) * 22
                       + np.count_nonzero(cm == 3) * (30 + 4 * 64))
    return cm.size * (2 * 64 * k1_pixel_ops(qpc) + 2 * chroma_dc) + chroma_pred


def k1_ops(qp: int, qpc: int, m16: np.ndarray, cm: np.ndarray) -> float:
    """int32 operations K1's function needs for one frame in these modes."""
    return i16_luma_ops(qp, m16) + chroma_ops(qpc, cm)


def i4x4_ops(qp: int, mode4: np.ndarray) -> float:
    """int32 operations of the Intra_4x4 coding of blocks in modes mode4:
    K1's per-sample pipeline with the DC quantised like the rest, and the
    prediction (V and H copy; DC sums 8 samples per block; a directional
    sample is (a + 2b + c + 2) >> 2 or (a + b + 1) >> 1, ~5)."""
    quant, dequant = (5, 3) if qp < 24 else (4, 2)
    modes = np.bincount(mode4.ravel(), minlength=9)
    return (mode4.size * 16 * (k1_pixel_ops(qp) + (quant + dequant) / 16)
            + modes[2] * 10 + modes[3:].sum() * 16 * 5)


def cavlc_size_ops(*levels) -> float:
    """int32 operations of the CAVLC bit sizes of blocks of zig-zag levels
    (arrays (..., L)): a test per coefficient, ~12 per nonzero one (level
    code, prefix and suffix length, suffixLength update, run_before) and
    ~10 per block (TrailingOnes, total_zeros, nC, coeff_token)."""
    return sum(lv.size + 12 * np.count_nonzero(lv) + 10 * (lv.size // lv.shape[-1])
               for lv in levels)


def k1_bound(w: int, h: int, qp: int, qpc: int, m16, cm):
    """(bound_ms, bound_by) of one K1 frame: each input byte read once
    (uint8 planes, int32 modes), each output byte written once, against the
    int32 operations its function needs in these modes."""
    nmb = (w // 16) * (h // 16)
    pixels = w * h * 3 // 2
    nbytes = 2 * pixels + 2 * 4 * nmb
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = k1_ops(qp, qpc, m16, cm) / INT32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def same_as(torch, want, label):
    """A check for cuda_ms: the output equals `want`, tensor by tensor."""
    def check(got):
        if max_err(torch, got, want) != 0:
            raise AssertionError(f"{label}: a timed call != plain")
    return check


def i16_inputs(torch, dev, frame, qp, modes):
    """Card planes and (mode16, chroma mode) of one frame: the decided modes,
    or the given arrays."""
    from h264_fer_tpu_torch.codec.intra_decision import intra16_mode_decision
    from h264_fer_tpu_torch.ops.intra import INTRA16_TO_CHROMA_MODE

    y, cb, cr = (torch.from_numpy(p).to(dev) for p in frame)
    if modes is None:
        m16 = intra16_mode_decision(y, qp)[0]
        cm = torch.from_numpy(INTRA16_TO_CHROMA_MODE).to(dev)[m16.long()]
    else:
        m16, cm = (torch.from_numpy(m).to(dev) for m in modes)
    return y, cb, cr, m16, cm


def check_k1(torch, dev, name, frame, qp, modes=None, blocks=None):
    """K1 kernel vs plain on one frame, in the decided modes or in the given
    (mode16, chroma mode) arrays, with the grid forced to `blocks` blocks
    if given; returns (max_abs_err, ms, plain_ms, bound_ms, bound_by,
    queued_ms)."""
    from h264_fer_tpu_torch.kernels.wavefront_i16 import i16_recon, i16_recon_plain
    from h264_fer_tpu_torch.ops.transform import chroma_qp

    y, cb, cr, m16, cm = i16_inputs(torch, dev, frame, qp, modes)
    qpc = chroma_qp(qp)
    label = f"K1 {name} qp{qp}" + (f" {blocks} blocks" if blocks else "")
    got = i16_recon(y, cb, cr, m16, cm, qp, qpc, blocks=blocks)
    want = i16_recon_plain(y, cb, cr, m16, cm, qp, qpc)
    err = max_err(torch, got, want)
    ms, queued_ms = kernel_ms(
        torch, lambda: i16_recon(y, cb, cr, m16, cm, qp, qpc, blocks=blocks), 20,
        check=same_as(torch, want, label))
    plain_ms = cuda_ms(torch, lambda: i16_recon_plain(y, cb, cr, m16, cm, qp, qpc), 2)
    print(f"{label}: max_abs_err {err} (tolerance 0, every timed call too), kernel "
          f"{ms:.4f} ms (queued {queued_ms:.4f}), plain {plain_ms:.2f} ms per frame",
          flush=True)
    if err != 0:
        raise AssertionError(f"{label}: kernel != plain")
    h, w = y.shape
    bound = k1_bound(w, h, qp, qpc, m16.cpu().numpy(), cm.cpu().numpy())
    return err, ms, plain_ms, *bound, queued_ms


def check_k1t(torch, dev, name, frame, qp, modes=None, blocks=None):
    """K1t kernel vs plain twin on one frame (recon and the four level
    arrays), and its recon vs K1's, in the decided modes or in the given
    (mode16, chroma mode) arrays, with the grid forced to `blocks` blocks
    if given; returns (max_abs_err, ms, plain_ms, bound_ms, bound_by,
    queued_ms)."""
    from h264_fer_tpu_torch.kernels.wavefront_i16 import (i16_frame, i16_frame_plain,
                                                          i16_recon)
    from h264_fer_tpu_torch.ops.transform import chroma_qp

    y, cb, cr, m16, cm = i16_inputs(torch, dev, frame, qp, modes)
    qpc = chroma_qp(qp)
    args = (y, cb, cr, m16, cm, qp, qpc)
    label = f"K1t {name} qp{qp}" + (f" {blocks} blocks" if blocks else "")
    got = i16_frame(*args, blocks=blocks)
    want, plain_ms = timed_once(torch, lambda: i16_frame_plain(*args))
    err = max_err(torch, got, want)
    k1_err = max_err(torch, [got[0], got[3], got[4]], i16_recon(*args))
    ms, queued_ms = kernel_ms(torch, lambda: i16_frame(*args, blocks=blocks), 20,
                              check=same_as(torch, want, label))
    h, w = y.shape
    nmb = (w // 16) * (h // 16)
    bound_ms, bound_by = bound(nbytes(y, cb, cr, m16, cm, *got),
                               k1_ops(qp, qpc, m16.cpu().numpy(), cm.cpu().numpy()))
    print(f"{label}: max_abs_err {err} (tolerance 0, every timed call too; recon vs K1 "
          f"{k1_err}), kernel {ms:.4f} ms (queued {queued_ms:.4f}), plain "
          f"{plain_ms:.2f} ms per frame, bound "
          f"{bound_ms:.4f} ms ({bound_by}; {nmb} MBs)", flush=True)
    if err != 0 or k1_err != 0:
        raise AssertionError(f"{label}: kernel != plain or != K1")
    return err, ms, plain_ms, bound_ms, bound_by, queued_ms


def k1_phase(torch, dev, rng):
    """Phase 2: K1 and K1t against their plain twins at small sizes, with
    the grid forced small, in random modes (drawn from rng) at QP 0 and 51,
    and at 1080p at each CHECK_QPS; then one K1 call, counted. Returns
    ({qp: K1's check_k1}, {qp: K1t's check_k1t}, K1's launches in that
    call)."""
    from h264_fer_tpu_torch.kernels.wavefront_i16 import i16_recon
    from h264_fer_tpu_torch.ops.transform import chroma_qp

    for label, w, h in SMALL + [("16x144", 16, 144), ("176x16", 176, 16)]:
        for check in (check_k1, check_k1t):
            check(torch, dev, label, content(1, w, h)[0], QP)
    for label, w, h in (("176x144", 176, 144), ("64x208", 64, 208)):
        for blocks in (1, 3):  # the persistent grid forced small
            for check in (check_k1, check_k1t):
                check(torch, dev, label, content(1, w, h)[0], QP, blocks=blocks)
    # every mode at every MB, the frame edges included, where the -1
    # neighbours of V, H and Plane enter the prediction
    for qp in (0, 51):
        modes = tuple(rng.integers(0, 4, 99).astype(np.int32) for _ in range(2))
        for check in (check_k1, check_k1t):
            check(torch, dev, "176x144 random modes", content(1, 176, 144)[0], qp, modes)
    k1, k1t = {}, {}
    frame = content(1, W, H)[0]
    for qp in CHECK_QPS:
        k1[qp] = check_k1(torch, dev, f"{W}x{H}", frame, qp)
        k1t[qp] = check_k1t(torch, dev, f"{W}x{H}", frame, qp)
    # K1's own path, now that K1t runs on every encode path: one call
    y, cb, cr = (torch.from_numpy(p).to(dev) for p in frame)
    modes = torch.zeros(y.numel() // 256, dtype=torch.int32, device=dev)
    i16_recon.launches = 0
    i16_recon(y, cb, cr, modes, modes, QP, chroma_qp(QP))
    return k1, k1t, i16_recon.launches


def check_bytes(path: str, stream: bytes) -> None:
    """Raise unless the 1080p stream of `path` has its STREAM_BYTES length."""
    if len(stream) != STREAM_BYTES[path]:
        raise AssertionError(f"{path} stream: {len(stream)} bytes, expected "
                             f"{STREAM_BYTES[path]}")


def decode_gate(torch, dev, label: str, stream: bytes, recon, kw: dict, name: str,
                timed: bool = True):
    """Decode `stream` with the port's Decoder on the card (native form,
    `kw` its deblock / spec_mode), after a warm-up, with K8's count set to 0
    just before: every frame must equal its reconstruction `recon` (uint8
    planes, on any device) exactly, and K8 must launch once per frame where
    the filter runs and never elsewhere. Then, when `timed`, times E2E_REPS
    more decodes. Returns (frames, median fps or None, K8 launches)."""
    from h264_fer_tpu_torch.codec.decoder import Decoder
    from h264_fer_tpu_torch.kernels.deblock import deblock_frame

    list(Decoder(device=dev, **kw).decode_annexb(stream))  # warm-up
    torch.cuda.synchronize()
    deblock_frame.launches = 0
    frames = list(Decoder(device=dev, **kw).decode_annexb(stream))
    launches = deblock_frame.launches
    if len(frames) != len(recon):
        raise AssertionError(f"decode {label}: {len(frames)} frames, expected {len(recon)}")
    for i, (got, want) in enumerate(zip(frames, recon)):
        for plane, a, b in zip(("y", "cb", "cr"), got, want):
            b = b.cpu().numpy()
            if a.shape != b.shape or not np.array_equal(a, b):
                bad = (np.count_nonzero(a != b) if a.shape == b.shape else "shape")
                raise AssertionError(f"decode {label}: frame {i} {plane} != its "
                                     f"reconstruction ({bad} samples differ)")
    if launches != (len(frames) if kw.get("deblock") else 0):
        raise AssertionError(f"decode {label}: K8 launched {launches} times for "
                             f"{len(frames)} frames with {kw}")
    if not timed:
        print(f"decode {label}: {len(frames)} frames {W}x{H} ({kw}) == their "
              f"reconstruction on {name}", flush=True)
        return len(frames), None, launches
    fps = []
    for _ in range(E2E_REPS):
        t0 = time.perf_counter()
        n = sum(1 for _ in Decoder(device=dev, **kw).decode_annexb(stream))
        fps.append(n / (time.perf_counter() - t0))
    fps.sort()
    print(f"decode {label}: {len(frames)} frames {W}x{H} ({kw}) == their "
          f"reconstruction; K8 {launches / len(frames):g} launches per frame; decode "
          f"fps median {fps[len(fps) // 2]:.2f} (runs {', '.join(f'{v:.2f}' for v in fps)}) "
          f"on {name}", flush=True)
    stages = decode_stages(torch, dev, stream, kw)
    print(f"decode {label} stages (host ms per frame, one decode): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()) + f" on {name}", flush=True)
    return len(frames), fps[len(fps) // 2], launches


def decode_stages(torch, dev, stream: bytes, kw: dict) -> dict:
    """Host ms per frame of one decode of `stream`: the native slice loop
    (parse and reconstruction), K8 (the call, synchronised) and the rest
    (NAL and header parse, uploads, read-back, the reference copy)."""
    from h264_fer_tpu_torch import native
    from h264_fer_tpu_torch.codec import decoder

    spent = {"slice_loop": 0.0, "k8": 0.0}

    def timed(key, fn, sync):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return wrapped

    with mock.patch.object(native, "decode_slice_native",
                           timed("slice_loop", native.decode_slice_native, False)), \
            mock.patch.object(decoder, "deblock_frame",
                              timed("k8", decoder.deblock_frame, True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(1 for _ in decoder.Decoder(device=dev, **kw).decode_annexb(stream))
        total = time.perf_counter() - t0
    out = {k: 1e3 * v / n for k, v in spent.items()}
    out["other"] = 1e3 * total / n - sum(out.values())
    out["total"] = 1e3 * total / n
    return out


def parse_stream(stream: bytes, n_frames: int, w: int, h: int, qp: int):
    """Read back SPS, PPS and the IDR slice headers with the port's parsers."""
    from h264_fer_tpu_torch.bitstream import nal
    from h264_fer_tpu_torch.bitstream.bitio import BitReader
    from h264_fer_tpu_torch.bitstream.params import I_SLICE, PPS, SPS, SliceHeader

    units = list(nal.iter_nal_units(stream))
    types = [u.nal_unit_type for u in units]
    if types != [nal.NAL_SPS, nal.NAL_PPS] + [nal.NAL_IDR] * n_frames:
        raise AssertionError(f"NAL sequence {types}")
    sps = SPS.parse(BitReader(units[0].rbsp))
    pps = PPS.parse(BitReader(units[1].rbsp))
    if (sps.width, sps.height) != (w, h) or pps.pic_init_qp != 14 + qp:
        raise AssertionError(f"SPS {sps.width}x{sps.height} PPS qp {pps.pic_init_qp}")
    for i, u in enumerate(units[2:]):
        sh = SliceHeader.parse(BitReader(u.rbsp), sps, pps, u.nal_unit_type,
                               u.nal_ref_idc)
        if (sh.slice_type != I_SLICE or sh.idr_pic_id != i
                or sh.slice_qp_y(pps) != qp):
            raise AssertionError(f"slice {i}: {sh}")


def stage_times(torch, dev, frame):
    """Device ms of each stage of one 1080p frame, CUDA events."""
    from h264_fer_tpu_torch.codec.entropy import i16_slice_entropy
    from h264_fer_tpu_torch.codec.intra_decision import intra16_mode_decision
    from h264_fer_tpu_torch.kernels.wavefront_i16 import i16_frame
    from h264_fer_tpu_torch.ops.intra import INTRA16_TO_CHROMA_MODE
    from h264_fer_tpu_torch.ops.transform import chroma_qp

    qpc = chroma_qp(QP)
    y, cb, cr = (torch.from_numpy(p).to(dev) for p in frame)
    m16 = intra16_mode_decision(y, QP)[0]
    cm = torch.from_numpy(INTRA16_TO_CHROMA_MODE).to(dev)[m16.long()]
    _, i16dc, ac, _, _, cdc, cac = i16_frame(y, cb, cr, m16, cm, QP, qpc)
    return {
        "mode_decision": cuda_ms(torch, lambda: intra16_mode_decision(y, QP), 5),
        "k1t_recon_levels": cuda_ms(torch, lambda: i16_frame(y, cb, cr, m16, cm, QP, qpc), 5),
        "entropy": cuda_ms(torch, lambda: i16_slice_entropy(
            m16, cm, i16dc, ac, cdc, cac, wmb=W // 16, hmb=H // 16), 5),
    }


def device_busy(torch, fn):
    """Profile one call of fn(): (wall ms, summed kernel ms, the largest
    kernels as (name, ms, count)). Kernel time 0 means the profiler saw
    no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    gc.collect()  # nothing left for the collector to free inside the window
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return wall * 1e3, busy, [(e.key, e.self_device_time_total / 1e3, e.count)
                              for e in top]


def replay_busy(torch, fn):
    """One call of fn(), whose device work is device program replays,
    after a warm-up call: (wall ms, device ms of the replays, the number
    of replays). Each replay is bracketed by CUDA events on its stream
    (DeviceProgram.spans), so the device time counts each graph from its
    first launch to its last, the gaps inside it included, and no copy
    between replays. torch.profiler is not run over graph replays: its
    CUPTI tracing crashed the process (SIGSEGV in CUDAGraph.replay) in 2
    of 8 full runs of this script on an H100, both over the session's
    replays."""
    from h264_fer_tpu_torch.codec.program import DeviceProgram

    fn()
    torch.cuda.synchronize()
    DeviceProgram.spans = spans = []
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        DeviceProgram.spans = None
    return wall * 1e3, sum(a.elapsed_time(b) for a, b in spans), len(spans)


def timed_once(torch, fn):
    """(fn(), device ms of that one call), timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def build_all():
    """Build every kernel source (one nvcc each) and the native slice
    decoder (g++), all started at once, and print each build's time and
    compiler report."""
    from h264_fer_tpu_torch import native
    from h264_fer_tpu_torch.kernels import build

    def timed(name):
        t0 = time.perf_counter()
        if name == NATIVE_DECODER:
            lib, log = build.compile_host_source(native.SOURCE)
        else:
            lib, log = build.compile_source(name)
        return lib, log, time.perf_counter() - t0

    names = KERNEL_SOURCES + (NATIVE_DECODER,)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        done = dict(zip(names, pool.map(timed, names)))
    for name, (lib, log, sec) in done.items():
        tool = "g++" if name == NATIVE_DECODER else "nvcc"
        print(f"built {lib.name} in {sec:.1f} s\n--- {tool} {name} ---\n{log.strip()}",
              flush=True)
    print(f"all {len(done)} builds: {time.perf_counter() - t0:.1f} s wall", flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_moved: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the int32 operations over the CUDA cores' int32 rate."""
    t_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def max_err(torch, got, want) -> int:
    """Largest absolute difference over matching tensors (bools as 0/1)."""
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


P_KERNELS = ("interp", "me_int", "me_qpel", "wavefront_p", "mc", "residual_recon")
DECIDE_KEYS = ("skip", "mb_type", "mv", "mvd")


def p_kernels(plain: bool) -> dict:
    """K13 (frame and band), K2-K5, K4-band, K12 and the slice entropy (K10)
    as the stage callables of p_frame_stages: the wrappers and dispatchers,
    which launch the kernels on the card, or with `plain` their plain
    twins."""
    from h264_fer_tpu_torch.codec.entropy import p_slice_entropy, p_slice_entropy_plain
    from h264_fer_tpu_torch.codec.pframe import (pframe_residual_recon,
                                                 pframe_residual_recon_plain)
    from h264_fer_tpu_torch.kernels.mc import mc_bulk, mc_bulk_plain
    from h264_fer_tpu_torch.kernels.me_int import integer_score_map, integer_score_map_plain
    from h264_fer_tpu_torch.kernels.me_qpel import qpel_refine_map_plain, qpel_refine_maps
    from h264_fer_tpu_torch.kernels.wavefront_p import (pframe_decide, pframe_decide_band,
                                                        pframe_decide_plain)
    from h264_fer_tpu_torch.ops.interp import (interpolated_planes,
                                               interpolated_planes_banded,
                                               interpolated_planes_banded_plain,
                                               interpolated_planes_plain)

    if not plain:
        return {"interp": interpolated_planes, "interp_band": interpolated_planes_banded,
                "me_int": integer_score_map, "me_qpel": qpel_refine_maps,
                "wavefront_p": pframe_decide, "wavefront_p_band": pframe_decide_band,
                "mc": mc_bulk, "residual_recon": pframe_residual_recon,
                "entropy": p_slice_entropy}
    return {"interp": interpolated_planes_plain,
            "interp_band": interpolated_planes_banded_plain,
            "me_int": integer_score_map_plain,
            "me_qpel": lambda y, planes, c1, c2, ext, metric: (
                qpel_refine_map_plain(y, planes, c1, ext, metric),
                qpel_refine_map_plain(y, planes, c2, ext, metric)),
            "wavefront_p": pframe_decide_plain, "wavefront_p_band": pframe_decide_plain,
            "mc": mc_bulk_plain, "residual_recon": pframe_residual_recon_plain,
            "entropy": p_slice_entropy_plain}


def stage_fn(kern: dict, name: str, band: bool = False):
    """The callable of stage `name` among p_kernels' `kern`: K13's band
    form for "interp" with `band`."""
    return kern["interp_band" if band and name == "interp" else name]


def p_frame_stages(torch, kern, frame, ref, qp, mc_mv=None, window=WINDOW, band=False,
                   top=None):
    """One P frame through device_p_frame's stages (search window +-window,
    adaptive MAXDIFF, the prefilter below QP 36), with K13, K2-K5 and K12
    the callables `kern` of p_kernels. frame: (y, cb, cr) uint8 planes on one device;
    ref: (ref_y, ref_cb, ref_cr, prev_mv); mc_mv: MVs for K5 in place of
    the decision's. With `band`, one MB-row band's P step as
    parallel/tile_p.py runs it: frame the band's rows, ref's planes its
    reference rows between ext + 4 luma and ext_c + 1 chroma rows of the
    bands above and below (tile_p._window), prev_mv its MBs' rows, and
    K4-band ("wavefront_p_band") in place of K4 with `top` its halo.
    Returns (fns, args, outs): each stage's callable, its arguments and its
    output, by stage name."""
    from h264_fer_tpu_torch.codec.pframe import (adaptive_maxdiff, blocks_to_mbq,
                                                 me_centres, me_params)
    from h264_fer_tpu_torch.ops.interp import pad_chroma, pad_chroma_banded
    from h264_fer_tpu_torch.ops.transform import chroma_qp

    y, cb, cr = frame
    ref_y, ref_cb, ref_cr, prev_mv = ref
    h, w = y.shape
    wmb, hmb = w // 16, h // 16
    ext = window + 2
    ext_c = ext // 2 + 1
    metric_id, lam = me_params(qp)
    mbq = lambda x: blocks_to_mbq(x, wmb, hmb)  # noqa: E731
    fns = {**kern, "interp": stage_fn(kern, "interp", band),
           "entropy": lambda *a: kern["entropy"](*a, wmb=wmb, hmb=hmb)}
    pad = pad_chroma_banded if band else pad_chroma
    args, outs = {}, {}

    def run(name, *a):
        args[name] = a
        outs[name] = fns[name](*a)
        return outs[name]

    planes = run("interp", ref_y, ext)
    # K2 as pframe_maps runs it: the map in MB-quadrant order and the argmin
    im, best = run("me_int", y, planes[0], ext, window, metric_id, True)
    c1, c2_blk, c2, q2ok = me_centres(best, prev_mv, wmb, hmb, window)
    q1, q2 = run("me_qpel", y, planes, c1, c2_blk, ext, metric_id)
    maxdiff = adaptive_maxdiff(y, wmb, hmb, -1)
    k4 = ("wavefront_p_band",) if band else ("wavefront_p",)
    dec = run(*k4, y, planes, im.view(wmb * hmb, 4, -1), mbq(c1), mbq(q1), c2, mbq(q2),
              q2ok, maxdiff, wmb, hmb, window, ext, metric_id, lam, *((top,) if band else ()))
    pred = run("mc", planes, pad(ref_cb, ext_c), pad(ref_cr, ext_c),
               dec["mv"] if mc_mv is None else mc_mv, ext, ext_c, wmb, hmb)
    levels = run("residual_recon", y, cb, cr, *pred, dec["skip"], maxdiff, wmb,
                 hmb, qp, chroma_qp(qp), qp < 36)[0]
    run("entropy", dec["skip"], dec["mb_type"], dec["mvd"], levels["luma"],
        levels["cdc"], levels["cac"])
    return fns, args, outs


def kernel_outputs(out) -> list:
    """A K13, K2-K5 or K12 output as a list of tensors (K4's dict in
    DECIDE_KEYS order; K12's levels dict in its order, then the recon
    planes)."""
    if isinstance(out, dict):
        return [out[k] for k in DECIDE_KEYS]
    if hasattr(out, "shape"):
        return [out]
    return [t for o in out for t in (o.values() if isinstance(o, dict) else (o,))]


def distinct(torch, size: int, index_sets) -> int:
    """How many distinct elements of a flat buffer of `size` elements the
    int64 index tensors `index_sets` name."""
    seen = None
    for idx in index_sets:
        if seen is None:
            seen = torch.zeros(size, dtype=torch.bool, device=idx.device)
        seen[idx.reshape(-1)] = True
    return int(seen.sum())


def qpel_reads(torch, y, planes, centres, ext) -> int:
    """Bytes of the distinct phase samples K3's function reads: the 8x8
    window of every block at each of the 49 offsets around each centre."""
    _, he, we = planes.shape
    h, w = y.shape
    wb = w // 8
    blk = torch.arange((h // 8) * wb, device=y.device)
    bx0, by0 = (blk % wb) * 8, (blk // wb) * 8
    ii = torch.arange(8, device=y.device)
    win = (ii[:, None] * we + ii[None, :]).reshape(-1)

    def windows():
        for c in centres:
            for k in range(49):
                mvx, mvy = c[:, 0] + k % 7 - 3, c[:, 1] + k // 7 - 3
                yield ((((mvy & 3) * 4 + (mvx & 3)).long() * he
                        + (by0 + (mvy >> 2) + ext).clamp(0, he - 8)) * we
                       + (bx0 + (mvx >> 2) + ext).clamp(0, we - 8))[:, None] + win

    return distinct(torch, planes.numel(), windows())


def mc_reads(torch, planes, c_pad, mv, ext, ext_c, wmb, hmb) -> int:
    """Bytes of the distinct samples K5's function reads: one phase sample
    per luma output, and in each chroma plane the bilinear taps of nonzero
    weight of every chroma output."""
    _, he, we = planes.shape
    hp, wp = c_pad.shape
    dev = mv.device

    def per_sample(n):  # (MV x, MV y, x, y) of every sample of n x n quadrants
        m = (mv.reshape(hmb, wmb, 2, 2, 2).permute(0, 2, 1, 3, 4)
             .reshape(2 * hmb, 2 * wmb, 2).repeat_interleave(n, 0)
             .repeat_interleave(n, 1))
        yy, xx = torch.meshgrid(torch.arange(m.shape[0], device=dev),
                                torch.arange(m.shape[1], device=dev), indexing="ij")
        return m[..., 0], m[..., 1], xx, yy

    mvx, mvy, xx, yy = per_sample(8)
    luma = ((((mvy & 3) * 4 + (mvx & 3)).long() * he
             + (yy + (mvy >> 2) + ext).clamp(0, he - 1)) * we
            + (xx + (mvx >> 2) + ext).clamp(0, we - 1))
    mvx, mvy, xx, yy = per_sample(4)
    fx, fy = (mvx & 7) > 0, (mvy & 7) > 0
    a = ((yy + (mvy >> 3) + ext_c + 1).clamp(0, hp - 2) * wp
         + (xx + (mvx >> 3) + ext_c + 1).clamp(0, wp - 2))
    # a tap of zero weight is not needed; it names the first tap again
    taps = (a, torch.where(fx, a + 1, a), torch.where(fy, a + wp, a),
            torch.where(fx & fy, a + wp + 1, a))
    return (distinct(torch, planes.numel(), [luma])
            + 2 * distinct(torch, c_pad.numel(), taps))


def p_work(torch, args, outs, k4: str = "wavefront_p") -> dict:
    """{kernel: (bytes, int32 operations)} that each of K13's, K2-K5's and
    K12's functions needs on these inputs: each input sample it reads counted once, each
    output once. K2's and K3's operations in packed bytes, 2 per 4 samples
    (a per-byte absolute difference, a 4-way dot product that sums it or
    its square), as K3 computes them; K2's bytes count its map and its
    index out. k4: K4's stage name ("wavefront_p_band": K4-band, its halo
    read once too)."""
    y, plane0, _, window = args["me_int"][:4]
    h, w = y.shape
    nb, nmb = (h // 8) * (w // 8), (h // 16) * (w // 16)
    S2 = (2 * window + 1) ** 2
    _, _, c1, c2_blk, _, _ = args["me_qpel"]
    d = args[k4]
    dec = outs[k4]
    top = d[15] if len(d) > 15 and d[15] is not None else ()  # K4-band's halo
    planes, cb_pad, cr_pad, mv, ext, ext_c, wmb, hmb = args["mc"]
    # K4 reads the skip test's 16x16 window at every MB and the unify
    # trial's four at every MB whose final type shows it ran (coded, type
    # != 0); a trial that unified the MB (type 0) is not counted
    trials = int(((~dec["skip"]) & (dec["mb_type"] != 0)).sum())
    res = args["residual_recon"]
    return {
        "me_int": (nbytes(y, plane0, *kernel_outputs(outs["me_int"])), nb * S2 * 16 * 2),
        "me_qpel": (nbytes(y, c1, c2_blk, *outs["me_qpel"])
                    + qpel_reads(torch, y, planes, (c1, c2_blk), ext),
                    2 * nb * 49 * 16 * 2),
        # skip test 256 x (sub, abs, compare); 4 x 387 candidate costs of 8
        # (2 sub, 2 abs, add, mul, add, compare); a unify trial 4 x 256 x 3
        k4: (nbytes(d[0], *d[2:9], *kernel_outputs(dec), *top) + 256 * (nmb + 4 * trials),
             nmb * (256 * 3 + 4 * (S2 + 98) * 8) + trials * 4 * 256 * 3),
        # luma: phase index and two shifted coordinates, ~8 per sample;
        # chroma: the 4-tap bilinear and its weights, ~20 per sample
        "mc": (nbytes(mv, *outs["mc"])
               + mc_reads(torch, planes, cb_pad, mv, ext, ext_c, wmb, hmb),
               h * w * 8 + (h * w // 2) * 20),
        # each half-pel value once: three 6-taps a position (hv, b, j: six
        # multiply-adds, rounding, shift, two-sided clip, ~10 each) and
        # twelve averages (add, +1, shift)
        "interp": (nbytes(args["interp"][0], outs["interp"]),
                   outs["interp"][0].numel() * (3 * 10 + 12 * 3)),
        # K1's per-sample pipeline at this QP, and the prefilter's subtract,
        # abs, compare and select where it is on
        "residual_recon": (nbytes(*res[:8], *kernel_outputs(outs["residual_recon"])),
                           h * w * 3 // 2 * (k1_pixel_ops(res[10]) + 4 * bool(res[12]))),
    }


def check_p_kernels(torch, label, ref, src, prev_mv, qp, mc_mv=None,
                    time_it=False, blocks=(), window=WINDOW):
    """K13, K2-K5 and K12 kernel vs plain twin on one frame pair, each
    kernel fed the plain chain's inputs. ref / src: (y, cb, cr) uint8 planes on the card;
    prev_mv: the previous frame's MVs (nmb, 4, 2); mc_mv: MVs for K5 (the
    plain decision's when None); blocks: grid sizes to force on K4 in
    further checks; window: the search range (ext = window + 2). Returns
    {kernel: (max_abs_err, ms, plain_ms, bound_ms, bound_by, queued_ms)}
    (times None unless time_it; every timed call is held to the plain
    output too) and the plain decision."""
    from h264_fer_tpu_torch.kernels.wavefront_p import pframe_decide

    kern = p_kernels(plain=False)
    plain, args, outs = p_frame_stages(torch, p_kernels(plain=True), src,
                                       (*ref, prev_mv), qp, mc_mv, window)
    work = p_work(torch, args, outs)
    out = {}
    for name in P_KERNELS:
        a = args[name]
        want = kernel_outputs(outs[name])
        got = kernel_outputs(kern[name](*a))
        torch.cuda.synchronize()
        err = max_err(torch, got, want)
        if name == "me_int":  # its other forms on the same inputs
            err = max(err, check_k2_forms(torch, a[:5]))
        if name == "wavefront_p":
            for b in blocks:
                err_b = max_err(torch, kernel_outputs(pframe_decide(*a, blocks=b)), want)
                print(f"{name} {label} qp{qp} grid of {b} blocks: max_abs_err {err_b}",
                      flush=True)
                err = max(err, err_b)
        ms = plain_ms = queued_ms = None
        if time_it:
            def check(o, name=name, want=want):
                if max_err(torch, kernel_outputs(o), want):
                    raise AssertionError(f"{name} != plain in a timed call at {label} qp{qp}")
            ms, queued_ms = kernel_ms(torch, lambda: kern[name](*a), 20, check)
            plain_ms = cuda_ms(torch, lambda: plain[name](*a), 1)
            if name == "me_int":
                k2_unfused(torch, a[:5], want, ms, queued_ms)
        bound_ms, bound_by = bound(*work[name])
        print(f"{name} {label} qp{qp}: max_abs_err {err} (tolerance 0)"
              + (f", kernel {ms:.4f} ms (queued {queued_ms:.4f}), plain {plain_ms:.2f} ms"
                 if time_it else "")
              + f", bound {bound_ms:.4f} ms ({bound_by}, {work[name][0]} bytes)",
              flush=True)
        if err != 0:
            raise AssertionError(f"{name} kernel != plain at {label} qp{qp}")
        out[name] = (err, ms, plain_ms, bound_ms, bound_by, queued_ms)
    return out, outs["wavefront_p"]


def check_k2_forms(torch, a) -> int:
    """K2 in each form (the block-order map; on a grid of whole MBs the P
    frame's, the map in MB-quadrant order and the argmin) against its plain
    twin on a = (src_y, plane0, ext, window, metric_id): the largest
    error."""
    from h264_fer_tpu_torch.kernels.me_int import integer_score_map, integer_score_map_plain

    h, w = a[0].shape
    err = 0
    for p_frame in (False, True) if h % 16 == 0 and w % 16 == 0 else (False,):
        got = kernel_outputs(integer_score_map(*a, p_frame))
        err = max(err, max_err(torch, got,
                               kernel_outputs(integer_score_map_plain(*a, p_frame))))
    torch.cuda.synchronize()
    return err


def k2_unfused(torch, a, want, ms, queued_ms) -> None:
    """Print K2's one launch (the map in MB-quadrant order and the argmin,
    `ms` and `queued_ms` as timed) beside what a P frame ran before it
    wrote both: K2's block-order map, then the eager argmin and
    blocks_to_mbq copy of the map, each call held to `want`."""
    from h264_fer_tpu_torch.kernels.me_int import integer_score_map
    from h264_fer_tpu_torch.ops.tiles import blocks_to_mbq

    h, w = a[0].shape

    def unfused():
        m = integer_score_map(*a)
        return blocks_to_mbq(m, w // 16, h // 16).view(m.shape), m.argmin(dim=1).to(torch.int32)

    def check(o):
        if max_err(torch, list(o), want):
            raise AssertionError("K2 block map + eager argmin and order != plain")
    glue_ms, glue_queued_ms = kernel_ms(torch, unfused, 20, check)
    print(f"me_int: one launch (map in MB-quadrant order + argmin) {ms:.4f} ms (queued "
          f"{queued_ms:.4f}); block-order map + eager argmin + blocks_to_mbq {glue_ms:.4f} ms "
          f"(queued {glue_queued_ms:.4f})", flush=True)


def check_k2_shapes(torch, dev) -> int:
    """K2 in both forms and every metric against its plain twin on inputs
    the P paths' frames do not give it: QCIF at ext 10 (22 blocks a row, a
    tile and a tail), 1080p at window 7 / ext 9 (plane pitch 1,938, 2 mod 4),
    at ext = window = 8 (full_search_topk's plane), flat (every shift
    ties), windows 0 and 4, windows 12 and 17 (more shift rows or columns
    than a thread keeps), and a 40x24 grid of odd block counts (block
    order only). Returns the largest error."""
    from h264_fer_tpu_torch.ops.interp import edge_pad

    def luma(n, w, h):
        return [torch.from_numpy(f[0]).to(dev) for f in content(n, w, h)]

    qcif, full, odd = luma(2, 176, 144), luma(2, W, H), luma(2, 40, 24)
    flat = torch.full((H, W), 128, dtype=torch.uint8, device=dev)
    cases = (("176x144", qcif, 10, 8), (f"{W}x{H}", full, 9, 7), (f"{W}x{H}", full, 8, 8),
             (f"{W}x{H} flat", [flat, flat], 10, 8), ("176x144", qcif, 2, 0),
             ("176x144", qcif, 6, 4), ("176x144", qcif, 12, 12), ("176x144", qcif, 17, 17),
             ("40x24", odd, 6, 4))
    worst = 0
    for label, (ref, src), ext, window in cases:
        plane0 = edge_pad(ref, ext).contiguous()
        err = max(check_k2_forms(torch, (src, plane0, ext, window, m)) for m in (0, 1, 2))
        print(f"me_int {label} ext {ext} window {window}: max_abs_err {err} (tolerance 0; "
              "every metric, both forms)", flush=True)
        if err:
            raise AssertionError(f"K2 != plain at {label} ext {ext} window {window}")
        worst = max(worst, err)
    return worst


def check_p_small_grids(torch, dev):
    """K2-K5 on QCIF: random previous MVs up to beyond the search limit (so
    q2 lanes are both valid and masked, and c2 is clamped), random MC MVs
    over the whole ±lim range (with K4's grid forced to 1 and 3 blocks too),
    and flat content where every score ties; the same random MVs at window
    7, whose luma rows (W + 18 bytes) are only 2-byte aligned where window
    8's chroma rows are; then a tall (64x208), a one-MB-wide (16x144) and a
    one-MB-tall (176x16) content pair."""
    rng = np.random.default_rng(SEED)
    lim = 4 * (WINDOW + 2) - 4

    def pair(w, h):
        return [tuple(torch.from_numpy(p).to(dev) for p in f) for f in content(2, w, h)]

    def rand_mv(lo, hi, nmb):
        return torch.from_numpy(rng.integers(lo, hi, (nmb, 4, 2)).astype(np.int32)).to(dev)

    qcif = pair(176, 144)
    flat = tuple(torch.full(p.shape, 128, dtype=torch.uint8, device=dev)
                 for p in qcif[0])
    for qp in P_QPS:
        prev = rand_mv(-lim - 4, lim + 5, 99)
        check_p_kernels(torch, "176x144 random MVs", qcif[0], qcif[1], prev, qp,
                        mc_mv=rand_mv(-lim, lim + 1, 99),
                        blocks=(1, 3) if qp == QP else ())
        check_p_kernels(torch, "176x144 flat (ties)", flat, flat, prev, qp)
    lim7 = 4 * (7 + 2) - 4
    for qp in P_QPS:
        check_p_kernels(torch, "176x144 window 7 random MVs", qcif[0], qcif[1],
                        rand_mv(-lim7 - 4, lim7 + 5, 99), qp,
                        mc_mv=rand_mv(-lim7, lim7 + 1, 99), window=7)
    for w, h in ((64, 208), (16, 144), (176, 16)):
        f0, f1 = pair(w, h)
        nmb = (w // 16) * (h // 16)
        check_p_kernels(torch, f"{w}x{h}", f0, f1, rand_mv(-lim - 4, lim + 5, nmb), QP)


def checkerboard(h: int, w: int) -> np.ndarray:
    """An (h, w) uint8 plane of 2x2 cells of 0 and 255: the 6-taps over it
    clip at both ends."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.where((yy // 2 + xx // 2) % 2, 255, 0).astype(np.uint8)


def check_k12_k13(torch, dev) -> dict:
    """K12 and K13 against their plain twins on the card, bit-exact, on
    inputs the content pairs do not reach: on the decided inputs of a
    1080p QP 28 P frame, the prefilter on and off with MAXDIFF 3 and 255 in
    every MB, and every MB skipped and none; prediction 0 against source
    255 and the reverse at each P QP (the prefilter on below QP 36); K13 on
    a 0/255 checkerboard reference at windows 8 and 7 (rows of W + 2 ext =
    0 and 2 mod 4 bytes), the frame and the K13_BANDS, each band also
    against the frame planes' rows, and on rows under 32 bytes and a plane
    of odd width at an odd address. Returns {stage: max_abs_err}."""
    from h264_fer_tpu_torch.ops.transform import chroma_qp

    kern, plain = p_kernels(plain=False), p_kernels(plain=True)
    pair = [tuple(torch.from_numpy(p).to(dev) for p in f) for f in content(2, W, H)]
    nmb = (W // 16) * (H // 16)
    zero = torch.zeros((nmb, 4, 2), dtype=torch.int32, device=dev)
    a = list(p_frame_stages(torch, kern, pair[1], (*pair[0], zero), QP)[1]["residual_recon"])
    full = lambda v, dtype: torch.full((nmb,), v, dtype=dtype, device=dev)  # noqa: E731
    cases = [(f"maxdiff {md}, prefilter {pf}", a[:7] + [full(md, torch.int32)] + a[8:12] + [pf])
             for md in (3, 255) for pf in (True, False)]
    cases += [(f"{'every' if sk else 'no'} MB skipped", a[:6] + [full(sk, torch.bool)] + a[7:])
              for sk in (True, False)]
    for qp in P_QPS:
        for s_val, p_val in ((255, 0), (0, 255)):
            src = [torch.full_like(x, s_val) for x in pair[1]]
            pred = [torch.full(x.shape, p_val, dtype=torch.int32, device=dev) for x in pair[1]]
            cases.append((f"source {s_val}, prediction {p_val}, qp{qp}",
                          [*src, *pred, full(False, torch.bool), full(3, torch.int32),
                           W // 16, H // 16, qp, chroma_qp(qp), qp < 36]))
    errs = {"residual_recon": 0, "interp": 0}
    for label, c in cases:
        err = max_err(torch, kernel_outputs(kern["residual_recon"](*c)),
                      kernel_outputs(plain["residual_recon"](*c)))
        print(f"residual_recon {W}x{H} {label}: max_abs_err {err} (tolerance 0)", flush=True)
        errs["residual_recon"] = max(errs["residual_recon"], err)
    board = torch.from_numpy(checkerboard(H, W)).to(dev)
    for window in (WINDOW, 7):
        ext = window + 2
        frame = kern["interp"](board, ext)
        err = max_err(torch, [frame], [plain["interp"](board, ext)])
        for n_tile, t in K13_BANDS:
            band = band_reference((board, board[::2, ::2], board[::2, ::2], zero), t, n_tile,
                                  window)[0].contiguous()
            r0 = 16 * (H // 16 // n_tile) * t
            got = kern["interp_band"](band, ext)
            err = max(err, max_err(torch, [got], [plain["interp_band"](band, ext)]),
                      max_err(torch, [got], [frame[:, r0: r0 + got.shape[1]]]))
        print(f"interp {W}x{H} checkerboard window {window}, frame and bands "
              + ", ".join(f"{t} of {n}" for n, t in K13_BANDS)
              + f": max_abs_err {err} (tolerance 0)", flush=True)
        errs["interp"] = max(errs["interp"], err)
    # rows under 32 bytes (stored byte by byte), and a plane of odd width at
    # an odd address (byte reads of the reference)
    rng = np.random.default_rng(SEED + 13)
    odd = torch.from_numpy(rng.integers(0, 256, 37 * 51 + 1, dtype=np.uint8)).to(dev)[1:]
    for label, ref, ext in (("16x16", torch.from_numpy(rng.integers(
            0, 256, (16, 16), dtype=np.uint8)).to(dev), 3), ("51x37 at an odd address",
                                                             odd.view(37, 51), 0)):
        err = max_err(torch, [kern["interp"](ref, ext)], [plain["interp"](ref, ext)])
        print(f"interp {label} ext {ext}: max_abs_err {err} (tolerance 0)", flush=True)
        errs["interp"] = max(errs["interp"], err)
    if any(errs.values()):
        raise AssertionError(f"K12 / K13 != plain: {errs}")
    return errs


def plain_i16_payload(torch, dev, enc, frame):
    """One all-I16 frame through the oracle chain on the card: the plain
    mode decision, plain K1t (plain K1, then the levels from its recon) and
    the plain entropy. Returns (payload dict, recon planes)."""
    from h264_fer_tpu_torch.codec.entropy import i16_slice_entropy_plain
    from h264_fer_tpu_torch.codec.intra_decision import intra16_mode_decision_plain
    from h264_fer_tpu_torch.kernels.wavefront_i16 import i16_frame_plain
    from h264_fer_tpu_torch.ops.intra import INTRA16_TO_CHROMA_MODE

    y, cb, cr = (torch.tensor(p, device=dev) for p in frame)
    m16 = intra16_mode_decision_plain(y, enc.qp)[0]
    cm = torch.from_numpy(INTRA16_TO_CHROMA_MODE).to(dev)[m16.long()]
    ry, i16dc, ac, rcb, rcr, cdc, cac = i16_frame_plain(y, cb, cr, m16, cm, enc.qp, enc.qpc)
    return (i16_slice_entropy_plain(m16, cm, i16dc, ac, cdc, cac, wmb=enc.wmb, hmb=enc.hmb),
            (ry, rcb, rcr))


def plain_chain(torch, dev, enc, frames):
    """The stream of the oracle chain on the card (plain mode decision,
    K1t and entropy per frame, stitched by the encoder) and each frame's
    recon planes."""
    out = [plain_i16_payload(torch, dev, enc, f) for f in frames]
    return enc.stitch([pay for pay, _ in out]), [rec for _, rec in out]


def plain_chain_stream(torch, dev, enc, frames) -> bytes:
    """The stream of the oracle chain on the card (plain_chain's)."""
    return plain_chain(torch, dev, enc, frames)[0]


def plain_p_frame(torch, enc, frame, ref):
    """One P frame through the oracle chain: device_p_frame's stages with
    the plain twins of K2-K5. frame (y, cb, cr) uint8 on the device; ref
    (ref_y, ref_cb, ref_cr, prev_mv)."""
    _, _, outs = p_frame_stages(torch, p_kernels(plain=True), frame, ref, enc.qp)
    _, ry, rcb, rcr = outs["residual_recon"]
    dec = outs["wavefront_p"]
    u8 = torch.uint8
    return {"recon_y": ry.to(u8), "recon_cb": rcb.to(u8), "recon_cr": rcr.to(u8),
            "skip": dec["skip"], "mv": dec["mv"], **outs["entropy"]}


def plain_ippp_stream(torch, dev, enc, frames) -> bytes:
    """The stream of one GOP (frames[0] the IDR) through the oracle chain on
    the card, stitched by the encoder."""
    from h264_fer_tpu_torch.codec.gop import next_reference

    i_pay, rec = plain_i16_payload(torch, dev, enc, frames[0])
    ref = (*rec, torch.zeros((enc.nmb, 4, 2), dtype=torch.int32, device=dev))
    payloads = [i_pay]
    for f, hdr_bits in zip(frames[1:], enc.hdr_bits):
        out = plain_p_frame(torch, enc, tuple(torch.tensor(p, device=dev) for p in f),
                            ref)
        ref = next_reference(ref, out, hdr_bits)
        payloads.append(out)
    return enc.stitch(payloads, [len(frames)])


def parse_ippp_stream(stream: bytes, lens, w: int, h: int, qp: int):
    """Read back SPS, PPS and every slice header of an IPPP stream: per GOP
    an IDR (idr_pic_id 0 for GOPs longer than one frame) and P slices with
    frame_num j and POC 2j, as GopIpppEncoder._set_hdrs writes them."""
    from h264_fer_tpu_torch.bitstream import nal
    from h264_fer_tpu_torch.bitstream.bitio import BitReader
    from h264_fer_tpu_torch.bitstream.params import I_SLICE, P_SLICE, PPS, SPS, SliceHeader

    units = list(nal.iter_nal_units(stream))
    want = [nal.NAL_SPS, nal.NAL_PPS]
    for n in lens:
        want += [nal.NAL_IDR] + [nal.NAL_NOT_IDR] * (n - 1)
    if [u.nal_unit_type for u in units] != want:
        raise AssertionError(f"NAL sequence {[u.nal_unit_type for u in units]}")
    sps = SPS.parse(BitReader(units[0].rbsp))
    pps = PPS.parse(BitReader(units[1].rbsp))
    if (sps.width, sps.height) != (w, h) or pps.pic_init_qp != 14 + qp:
        raise AssertionError(f"SPS {sps.width}x{sps.height} PPS qp {pps.pic_init_qp}")
    i = 2
    for n in lens:
        for j in range(n):
            u = units[i]
            sh = SliceHeader.parse(BitReader(u.rbsp), sps, pps, u.nal_unit_type,
                                   u.nal_ref_idc)
            ok = (sh.slice_type == I_SLICE and sh.idr_pic_id == 0 if j == 0
                  else sh.slice_type == P_SLICE and sh.frame_num == j
                  and sh.pic_order_cnt_lsb == 2 * j)
            if not ok or sh.slice_qp_y(pps) != qp:
                raise AssertionError(f"slice {i - 2}: {sh}")
            i += 1


def p_stage_times(torch, dev, frames):
    """Device ms of each stage of one 1080p P frame (CUDA events), the
    second frame predicted from the first, with the kernels."""
    ref, src = (tuple(torch.from_numpy(p).to(dev) for p in f) for f in frames[:2])
    prev = torch.zeros(((W // 16) * (H // 16), 4, 2), dtype=torch.int32, device=dev)
    fns, args, _ = p_frame_stages(torch, p_kernels(plain=False), src,
                                  (*ref, prev), QP)
    names = {"interp": "interp", "me_int": "k2_int_search", "me_qpel": "k3_qpel",
             "wavefront_p": "k4_decide", "mc": "k5_mc",
             "residual_recon": "residual_recon", "entropy": "entropy"}
    return {label: cuda_ms(torch, lambda: fns[name](*args[name]), 5)
            for name, label in names.items()}


MIXED_KERNELS = ("wavefront_chroma", "wavefront_i4x4", "wavefront_mixed")


def tall_frame():
    """A 64x208 frame (hmb 13 > wmb 4) of flat MBs with noise, where both
    MB classes win (the JAX package's tests/test_wavefront_mixed.py:58)."""
    rng = np.random.default_rng(3)
    w, h = 64, 208
    base = rng.integers(0, 200, (h // 16, w // 16))
    y = np.kron(base, np.ones((16, 16))).astype(np.uint8)
    y = np.clip(y + rng.integers(-20, 20, (h, w)), 0, 255).astype(np.uint8)
    return (y, rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))


def mixed_inputs(torch, frame, qp, chroma=None):
    """The mixed frame's stages up to K6 on one frame (y, cb, cr) on a
    device: returns (decision dict, chroma modes, chroma levels (cdc, cac),
    K6's arguments). chroma: K7 as a callable (cb, cr, cmodes, qpc) →
    (rcb, rcr, cdc, cac), followed by the mode decision on K11 and the
    chroma setup on K10; by default the plain chain, the plain decision,
    chroma_frame_plain and chroma_setup_plain."""
    from h264_fer_tpu_torch.codec.entropy import chroma_setup, chroma_setup_plain
    from h264_fer_tpu_torch.codec.intra_decision import (intra_mode_decision,
                                                         intra_mode_decision_plain)
    from h264_fer_tpu_torch.kernels.wavefront_i16 import chroma_frame_plain
    from h264_fer_tpu_torch.ops.intra import INTRA16_TO_CHROMA_MODE
    from h264_fer_tpu_torch.ops.transform import chroma_qp

    y, cb, cr = frame
    h, w = y.shape
    dec = (intra_mode_decision_plain if chroma is None else intra_mode_decision)(y, qp)
    cm = torch.from_numpy(INTRA16_TO_CHROMA_MODE).to(y.device)[dec["mode16"].long()]
    _, _, cdc, cac = (chroma or chroma_frame_plain)(cb, cr, cm, chroma_qp(qp))
    ch = (chroma_setup_plain if chroma is None else chroma_setup)(cdc, cac, w // 16, h // 16)
    return dec, cm, (cdc, cac), (y, dec["mode16"], dec["mode4"], cm,
                                 ch["cbp_chroma"], ch["bits"], qp)


def mixed_payload(dec, cm, cdc, cac, mx):
    """The slice payload of a mixed frame from its mode decision, chroma
    modes and levels, and K6's outputs mx, by the plain entropy (and the
    plain chroma setup)."""
    from h264_fer_tpu_torch.codec.entropy import chroma_setup_plain, mixed_slice_entropy_plain

    hmb, wmb = (n // 16 for n in mx["recon_y"].shape)
    return mixed_slice_entropy_plain(
        mx["choice4"], dec["mode16"], cm, mx["i16dc"], mx["i16ac"], mx["lv4"],
        mx["prev_flags"], mx["rem_modes"], mx["cbp_luma"], mx["tc_luma"], cdc, cac,
        wmb=wmb, hmb=hmb, chroma=chroma_setup_plain(cdc, cac, wmb, hmb))


def check_mixed_kernels(torch, label, frame, qp, mode4=None, time_it=False,
                        blocks=()):
    """K7 (recon and levels), K4x4 and K6 kernel vs plain twin on one frame
    (y, cb, cr) on the card, each fed the plain chain's inputs: the decided
    modes, or Intra4x4 modes mode4 in their place; blocks: grid sizes to
    force on K7, K4x4 and K6 in further checks. K7 runs both ways, with its
    levels (chroma_frame) and recon only (chroma_recon). Returns ({kernel:
    (max_abs_err, ms, plain_ms, bound_ms, bound_by, queued_ms)} (times None
    unless time_it; every timed call is held to the plain output too), the I4x4
    MB count of K6, K4x4's launches in its own path run when time_it, and
    the plain chain's slice payload of the frame)."""
    from h264_fer_tpu_torch.kernels.wavefront_i4x4 import i4x4_luma, i4x4_luma_plain
    from h264_fer_tpu_torch.kernels.wavefront_i16 import (chroma_frame, chroma_frame_plain,
                                                          chroma_recon)
    from h264_fer_tpu_torch.kernels.wavefront_mixed import (KEYS, TABLES, mixed_luma,
                                                            mixed_luma_plain)
    from h264_fer_tpu_torch.ops.transform import chroma_qp

    y, cb, cr = frame
    dec, cm, (cdc, cac), args = mixed_inputs(torch, frame, qp)
    if mode4 is not None:
        args = args[:2] + (mode4,) + args[3:]
    m4 = args[2]
    qpc = chroma_qp(qp)
    k4_launches = None
    if time_it:  # K4x4's own path: one call, counted
        i4x4_luma.launches = 0
    got4 = i4x4_luma(y, m4, qp)
    if time_it:
        k4_launches = i4x4_luma.launches
    got6 = mixed_luma(*args)
    got7 = chroma_frame(cb, cr, cm, qpc)
    got7r = chroma_recon(cb, cr, cm, qpc)
    want4, plain4_ms = timed_once(torch, lambda: i4x4_luma_plain(y, m4, qp))
    want6, plain6_ms = timed_once(torch, lambda: mixed_luma_plain(*args))
    want7, plain7_ms = timed_once(torch, lambda: chroma_frame_plain(cb, cr, cm, qpc))
    def err6(out):
        return max_err(torch, [out[k] for k in KEYS], [want6[k] for k in KEYS])

    errs = {"wavefront_chroma": max(max_err(torch, got7, want7),
                                    max_err(torch, got7r, want7[:2])),
            "wavefront_i4x4": max_err(torch, got4, want4),
            "wavefront_mixed": err6(got6)}
    for b in blocks:
        for name, err_b in (("wavefront_mixed", err6(mixed_luma(*args, blocks=b))),
                            ("wavefront_i4x4", max_err(torch, i4x4_luma(y, m4, qp, blocks=b),
                                                       want4)),
                            ("wavefront_chroma", max_err(torch, chroma_frame(
                                cb, cr, cm, qpc, blocks=b), want7)),
                            ("wavefront_chroma recon only", max_err(torch, chroma_recon(
                                cb, cr, cm, qpc, blocks=b), want7[:2]))):
            print(f"{name} {label} qp{qp} grid of {b} blocks: max_abs_err {err_b}",
                  flush=True)
            key = name.split()[0]
            errs[key] = max(errs[key], err_b)
    n4 = int(got6["choice4"].sum())
    nmb = got6["choice4"].numel()
    m16n, cmn, m4n = (t.cpu().numpy() for t in (args[1], cm, m4))
    lv = [got6[k].cpu().numpy() for k in ("i16dc", "i16ac", "lv4")]
    work = {  # (bytes, int32 operations) of each function on these inputs
        "wavefront_chroma": (nbytes(cb, cr, cm, *got7), chroma_ops(qpc, cmn)),
        "wavefront_i4x4": (nbytes(y, m4, *got4), i4x4_ops(qp, m4n)),
        # both candidates, the 33 blocks' CAVLC sizes, MPM and the choice
        "wavefront_mixed": (nbytes(*args[:6], *(got6[k] for k in KEYS)) + TABLES.nbytes,
                            i16_luma_ops(qp, m16n) + i4x4_ops(qp, m4n)
                            + cavlc_size_ops(*lv) + nmb * (16 * 8 + 100))}
    times = {}
    if time_it:
        def check4(out):
            if max_err(torch, out, want4):
                raise AssertionError(f"K4x4 != plain in a timed call at {label} qp{qp}")

        def check6(out):
            if err6(out):
                raise AssertionError(f"K6 != plain in a timed call at {label} qp{qp}")

        times = {"wavefront_chroma": (kernel_ms(torch, lambda: chroma_frame(cb, cr, cm, qpc),
                                                20, same_as(torch, want7, f"K7 {label} qp{qp}")),
                                      plain7_ms),
                 "wavefront_i4x4": (kernel_ms(torch, lambda: i4x4_luma(y, m4, qp), 20, check4),
                                    plain4_ms),
                 "wavefront_mixed": (kernel_ms(torch, lambda: mixed_luma(*args), 10, check6),
                                     plain6_ms)}
    out = {}
    for name in MIXED_KERNELS:
        bound_ms, bound_by = bound(*work[name])
        (ms, queued_ms), plain_ms = times.get(name, ((None, None), None))
        print(f"{name} {label} qp{qp}: max_abs_err {errs[name]} (tolerance 0)"
              + (f", kernel {ms:.4f} ms (queued {queued_ms:.4f}), plain {plain_ms:.1f} ms"
                 if time_it else "")
              + f", bound {bound_ms:.4f} ms ({bound_by}, {work[name][0]} bytes)",
              flush=True)
        if errs[name] != 0:
            raise AssertionError(f"{name} kernel != plain at {label} qp{qp}")
        out[name] = (errs[name], ms, plain_ms, bound_ms, bound_by, queued_ms)
    print(f"K6 {label} qp{qp}: {n4} I4x4 MBs of {nmb}", flush=True)
    return out, n4, k4_launches, mixed_payload(dec, cm, cdc, cac, want6)


def plain_mixed_payload(torch, dev, enc, frame):
    """One mixed frame through the oracle chain on a device: the plain mode
    decision, plain K7 and its levels, chroma setup, plain K6, mixed
    entropy."""
    from h264_fer_tpu_torch.kernels.wavefront_mixed import mixed_luma_plain

    planes = tuple(torch.tensor(p, device=dev) for p in frame)
    dec, cm, (cdc, cac), args = mixed_inputs(torch, planes, enc.qp)
    return mixed_payload(dec, cm, cdc, cac, mixed_luma_plain(*args))


def mixed_stage_times(torch, dev, frame):
    """Device ms of each stage of one 1080p mixed frame, CUDA events."""
    from h264_fer_tpu_torch.codec.entropy import chroma_setup, mixed_slice_entropy
    from h264_fer_tpu_torch.codec.intra_decision import intra_mode_decision
    from h264_fer_tpu_torch.kernels.wavefront_i16 import chroma_frame
    from h264_fer_tpu_torch.kernels.wavefront_mixed import mixed_luma
    from h264_fer_tpu_torch.ops.transform import chroma_qp

    qpc = chroma_qp(QP)
    y, cb, cr = (torch.from_numpy(p).to(dev) for p in frame)
    dec, cm, (cdc, cac), args = mixed_inputs(torch, (y, cb, cr), QP, chroma_frame)
    mx = mixed_luma(*args)
    ent_args = (mx["choice4"], dec["mode16"], cm, *(mx[k] for k in (
        "i16dc", "i16ac", "lv4", "prev_flags", "rem_modes", "cbp_luma", "tc_luma")),
        cdc, cac)
    ch = chroma_setup(cdc, cac, W // 16, H // 16)
    return {
        "mode_decision": cuda_ms(torch, lambda: intra_mode_decision(y, QP), 5),
        "k7_chroma_levels": cuda_ms(torch, lambda: chroma_frame(cb, cr, cm, qpc), 5),
        "chroma_setup": cuda_ms(torch, lambda: chroma_setup(cdc, cac, W // 16, H // 16), 5),
        "k6_mixed": cuda_ms(torch, lambda: mixed_luma(*args), 5),
        "entropy": cuda_ms(torch, lambda: mixed_slice_entropy(
            *ent_args, wmb=W // 16, hmb=H // 16, chroma=ch), 5),
    }


def k8_filtered_lines(state, qp: int, qpc: int):
    """(luma, chroma) lines that pass the alpha / beta test on an edge with
    bS > 0 in a plain K8 run on this state: the lines the filter proper
    works on. Counted by a wrapper around the plain twin's _filter_lines,
    on a run of its own so that the timed plain run stays as it is."""
    from unittest import mock

    from h264_fer_tpu_torch.kernels import deblock

    counts = [0, 0]
    inner = deblock._filter_lines

    def counted(s, bs, alpha, beta, tc0_tab, chroma):
        a0, a1 = s[..., 0], s[..., 1]
        passed = (((a0[0] - a0[1]).abs() < alpha) & ((a1 - a0).abs() < beta).all(0)
                  & (bs > 0))
        counts[chroma] += int(passed.sum())
        return inner(s, bs, alpha, beta, tc0_tab, chroma)

    with mock.patch.object(deblock, "_filter_lines", counted):
        deblock.deblock_frame_plain(*state, qp, qpc)
    return counts


def k8_ops(bs_v, bs_h, luma_lines: int, chroma_lines: int) -> float:
    """int32 operations of K8's function on these bS maps: ~10 to derive
    each bS, the alpha / beta test (~9) on every line of an edge with
    bS > 0 (a Cb and a Cr edge of 2 lines per luma 4-line group at luma
    offsets 0 and 8), and the filter itself (~36 a luma line, ~12 a chroma
    line) only on the lines that pass the test (k8_filtered_lines): the
    others return after it."""
    coded = (bs_v > 0).sum().item() + (bs_h > 0).sum().item()
    chroma = (bs_v[:, ::2] > 0).sum().item() + (bs_h[:, ::2] > 0).sum().item()
    return (32 * bs_v.shape[0] * 10 + (coded + chroma) * 4 * 9
            + luma_lines * 36 + chroma_lines * 12)


def check_k8(torch, label, state, qp, time_it=False, blocks=None):
    """K8 kernel vs plain twin on one frame's state (y, cb, cr uint8,
    mb_intra, nz_luma, mv) on the card, with the grid forced to `blocks`
    blocks if given. Returns (max_abs_err, ms, plain_ms, bound_ms, bound_by,
    queued_ms) (times and the bound None unless time_it; every timed call is held to the
    plain output) and the number of samples the filter changed."""
    from h264_fer_tpu_torch.kernels.deblock import bs_maps, deblock_frame, deblock_frame_plain
    from h264_fer_tpu_torch.ops.transform import chroma_qp

    qpc = chroma_qp(qp)
    label = label + (f" {blocks} blocks" if blocks else "")
    got = deblock_frame(*state, qp, qpc, blocks=blocks)
    want, plain_ms = timed_once(torch, lambda: deblock_frame_plain(*state, qp, qpc))
    err = max_err(torch, got, want)
    changed = sum(int((g != p).sum()) for g, p in zip(got, state[:3]))
    ms = queued_ms = bound_ms = bound_by = None
    timing = ""
    if time_it:
        ms, queued_ms = kernel_ms(
            torch, lambda: deblock_frame(*state, qp, qpc, blocks=blocks), 20,
            check=same_as(torch, want, f"K8 {label} qp{qp}"))
        h, w = state[0].shape
        bs_v, bs_h = bs_maps(*state[3:], w // 16, h // 16)
        lines = k8_filtered_lines(state, qp, qpc)
        bound_ms, bound_by = bound(nbytes(*state, *got), k8_ops(bs_v, bs_h, *lines))
        timing = (f", kernel {ms:.4f} ms (queued {queued_ms:.4f}; every timed call =="
                  " plain), bound "
                  f"{bound_ms:.4f} ms ({bound_by}; {lines[0]} luma + {lines[1]} chroma "
                  "lines filtered)")
    print(f"K8 {label} qp{qp}: max_abs_err {err} (tolerance 0), {changed} samples "
          f"filtered, plain {plain_ms:.1f} ms" + timing, flush=True)
    if err != 0:
        raise AssertionError(f"K8 kernel != plain at {label} qp{qp}")
    return (err, ms, plain_ms, bound_ms, bound_by, queued_ms), changed


def encoder_state(enc):
    """The state the session encoder's filter reads after its last frame,
    taken before the filter (run with deblock off): (recon y, cb, cr,
    mb_intra, nz_luma, mv) on its device."""
    return (*enc._ref, enc._mb_class == 6, enc._nz, enc._mv)


def random_state(torch, dev, w, h, seed):
    """Content planes and random P-frame state: mixed intra flags, sparse
    coded-block flags and quadrant MVs whose neighbour deltas fall on both
    sides of 4, so every bS 0-4 occurs."""
    rng = np.random.default_rng(seed)
    nmb = (w // 16) * (h // 16)
    mv = rng.integers(-3, 4, (nmb, 1, 2)) * 2 + rng.integers(-2, 3, (nmb, 4, 2))
    return (*(torch.from_numpy(p).to(dev) for p in content(1, w, h, seed)[0]),
            torch.from_numpy(rng.random(nmb) < 0.15).to(dev),
            torch.from_numpy(rng.random((nmb, 16)) < 0.3).to(dev),
            torch.from_numpy(mv.astype(np.int32)).to(dev))


def plain_patches():
    """Context managers that swap every kernel wrapper the session encoder
    calls for its plain twin, where the encoder's modules look it up: K10
    for the plain entropy, K11 for the plain mode decision, K12 and K13
    (in codec/pframe.py and parallel/tile_p.py) for the plain residual /
    recon and planes too."""
    from unittest import mock

    from h264_fer_tpu_torch.codec import encoder, entropy, iframe, intra_decision, pframe
    from h264_fer_tpu_torch.kernels.deblock import deblock_frame_plain
    from h264_fer_tpu_torch.kernels.wavefront_i16 import i16_frame_plain
    from h264_fer_tpu_torch.parallel import tile_p

    plain = p_kernels(plain=True)
    return [mock.patch.object(iframe, "i16_frame", i16_frame_plain),
            mock.patch.object(pframe, "interpolated_planes", plain["interp"]),
            mock.patch.object(pframe, "pframe_residual_recon", plain["residual_recon"]),
            mock.patch.object(tile_p, "interpolated_planes_banded", plain["interp_band"]),
            mock.patch.object(tile_p, "pframe_residual_recon", plain["residual_recon"]),
            mock.patch.object(iframe, "deblock_frame", deblock_frame_plain),
            mock.patch.object(encoder, "deblock_frame", deblock_frame_plain),
            mock.patch.object(pframe, "integer_score_map", plain["me_int"]),
            mock.patch.object(pframe, "qpel_refine_maps", plain["me_qpel"]),
            mock.patch.object(pframe, "pframe_decide", plain["wavefront_p"]),
            mock.patch.object(pframe, "mc_bulk", plain["mc"]),
            mock.patch.object(pframe, "p_slice_entropy", plain["entropy"]),
            mock.patch.object(iframe, "i16_slice_entropy", entropy.i16_slice_entropy_plain),
            mock.patch.object(iframe, "chroma_setup", entropy.chroma_setup_plain),
            mock.patch.object(iframe, "mixed_slice_entropy",
                              entropy.mixed_slice_entropy_plain),
            mock.patch.object(iframe, "intra16_mode_decision",
                              intra_decision.intra16_mode_decision_plain),
            mock.patch.object(iframe, "intra_mode_decision",
                              intra_decision.intra_mode_decision_plain),
            mock.patch.object(encoder, "intra_mode_decision",
                              intra_decision.intra_mode_decision_plain)]


def plain_session_stream(torch, dev, cfg, frames, counted) -> bytes:
    """The session stream of `frames` through the oracle chain on the card:
    the same Encoder with every kernel swapped for its plain twin, its
    device programs run eagerly. Fails if a counted kernel launched
    meanwhile."""
    from contextlib import ExitStack

    from h264_fer_tpu_torch.codec.encoder import Encoder

    before = [fn.launches for fn in counted]
    with ExitStack() as stack:
        for patch in plain_patches():
            stack.enter_context(patch)
        h, w = frames[0][0].shape
        stack.enter_context(eager_programs())
        stream = Encoder(w, h, cfg, device=dev).encode_sequence(frames)
    if [fn.launches for fn in counted] != before:
        raise AssertionError("a kernel launched in the plain session chain")
    return stream


def parse_session_stream(stream: bytes, stats, w: int, h: int, qp: int):
    """Read back SPS, PPS and every slice header of a session stream: the
    filter signalled in the PPS and enabled in every slice, the frame types
    of `stats`, and the reference's frame_num / POC / idr_pic_id sequence."""
    from h264_fer_tpu_torch.bitstream import nal
    from h264_fer_tpu_torch.bitstream.bitio import BitReader
    from h264_fer_tpu_torch.bitstream.params import I_SLICE, P_SLICE, PPS, SPS, SliceHeader

    units = list(nal.iter_nal_units(stream))
    want = [nal.NAL_SPS, nal.NAL_PPS] + [nal.NAL_IDR if s["idr"] else nal.NAL_NOT_IDR
                                         for s in stats]
    if [u.nal_unit_type for u in units] != want:
        raise AssertionError(f"NAL sequence {[u.nal_unit_type for u in units]}")
    sps = SPS.parse(BitReader(units[0].rbsp))
    pps = PPS.parse(BitReader(units[1].rbsp))
    if ((sps.width, sps.height) != (w, h) or pps.pic_init_qp != 14 + qp
            or pps.deblocking_filter_control_present_flag != 1):
        raise AssertionError(f"SPS {sps.width}x{sps.height} PPS {pps}")
    frame_num, idr_id, prev_idr = 0, -1, False
    for i, (u, s) in enumerate(zip(units[2:], stats)):
        sh = SliceHeader.parse(BitReader(u.rbsp), sps, pps, u.nal_unit_type, u.nal_ref_idc)
        if s["idr"]:
            frame_num, idr_id = 0, idr_id + 1 if prev_idr else 0
            ok = sh.slice_type == I_SLICE and sh.idr_pic_id == idr_id
        else:
            frame_num += 1
            ok = sh.slice_type == P_SLICE and sh.frame_num == frame_num
        prev_idr = s["idr"]
        if (not ok or sh.pic_order_cnt_lsb != 2 * frame_num
                or sh.disable_deblocking_filter_idc != 0 or sh.slice_qp_y(pps) != qp):
            raise AssertionError(f"slice {i}: {sh}")


BAND_TILES = 4  # the band kernels' checks: band 1 of 4 bands of 17 MB rows at 1080p
BAND_KERNELS = ("wavefront_i16_levels_band", "wavefront_chroma_band", "wavefront_mixed_band")


def check_band_kernels(torch, dev, frame, qp, time_it=False):
    """K1t-band, K7-band and K6-band kernel vs plain twin on band 1 of
    BAND_TILES of one 1080p frame (card tensors y, cb, cr), with a real
    halo: band 0's last rows as the full-frame kernels leave them (K1t's
    recon; K7's chroma recon; K6's recon row, classes, TotalCoeffs and CBP,
    with band 0's last-row Intra4x4 modes). Each band kernel's outputs must
    also equal the full-frame kernel's rows of the band. Returns {kernel:
    (max_abs_err, ms, plain_ms, bound_ms, bound_by, queued_ms)} (times None
    unless time_it; every timed call is held to the plain output too)."""
    from h264_fer_tpu_torch.codec.intra_decision import intra16_mode_decision
    from h264_fer_tpu_torch.kernels.wavefront_i16 import (chroma_band, chroma_frame,
                                                          chroma_frame_plain, i16_band,
                                                          i16_frame, i16_frame_plain)
    from h264_fer_tpu_torch.kernels.wavefront_mixed import (KEYS, TABLES, mixed_luma,
                                                            mixed_luma_band,
                                                            mixed_luma_plain)
    from h264_fer_tpu_torch.ops.intra import INTRA16_TO_CHROMA_MODE
    from h264_fer_tpu_torch.ops.transform import chroma_qp

    y, cb, cr = frame
    h, w = y.shape
    wmb, hloc = w // 16, h // 16 // BAND_TILES
    r0, qpc = hloc, chroma_qp(qp)  # band 1: MB rows [r0, r0 + hloc)

    def band(x, per_row):  # band 1's rows of a plane or a per-MB array
        return x[per_row * r0: per_row * (r0 + hloc)]

    m16 = intra16_mode_decision(y, qp)[0]
    cm = torch.from_numpy(INTRA16_TO_CHROMA_MODE).to(dev)[m16.long()]
    # K1t-band
    full = i16_frame(y, cb, cr, m16, cm, qp, qpc)
    top = (full[0][16 * r0 - 1], full[3][8 * r0 - 1], full[4][8 * r0 - 1])
    a1 = (band(y, 16), band(cb, 8), band(cr, 8), band(m16, wmb), band(cm, wmb), qp, qpc, top)
    got1 = i16_band(*a1)
    want1, plain1_ms = timed_once(torch, lambda: i16_frame_plain(*a1))
    rows1 = [band(full[k], 16 if k == 0 else 8 if k in (3, 4) else wmb) for k in range(5)]
    rows1 += [full[k][:, wmb * r0: wmb * (r0 + hloc)] for k in (5, 6)]
    errs = {"wavefront_i16_levels_band": max(max_err(torch, got1, want1),
                                             max_err(torch, got1, rows1))}
    # K7-band
    full7 = chroma_frame(cb, cr, cm, qpc)
    top7 = (full7[0][8 * r0 - 1], full7[1][8 * r0 - 1])
    a7 = (band(cb, 8), band(cr, 8), band(cm, wmb), qpc, top7)
    got7 = chroma_band(*a7)
    want7, plain7_ms = timed_once(torch, lambda: chroma_frame_plain(*a7))
    rows7 = [band(full7[0], 8), band(full7[1], 8)] + [
        full7[k][:, wmb * r0: wmb * (r0 + hloc)] for k in (2, 3)]
    errs["wavefront_chroma_band"] = max(max_err(torch, got7, want7),
                                        max_err(torch, got7, rows7))
    # K6-band
    dec, cm6, _, args = mixed_inputs(torch, frame, qp, chroma=chroma_frame)
    full6 = mixed_luma(*args)
    mb_t = slice(wmb * (r0 - 1), wmb * r0)  # band 0's last MB row
    top6 = {"recon": full6["recon_y"][16 * r0 - 1], "choice4": full6["choice4"][mb_t],
            "tc_luma": full6["tc_luma"][mb_t], "cbp_luma": full6["cbp_luma"][mb_t],
            "mode4": dec["mode4"][mb_t]}
    a6 = (band(y, 16), *(band(t, wmb) for t in args[1:6]), qp)
    got6 = mixed_luma_band(*a6, top6)
    want6, plain6_ms = timed_once(torch, lambda: mixed_luma_plain(*a6, top6))

    def err6(out):
        return max_err(torch, [out[k] for k in KEYS], [want6[k] for k in KEYS])

    errs["wavefront_mixed_band"] = max(err6(got6), max_err(
        torch, [got6[k] for k in KEYS],
        [band(full6[k], 16 if k == "recon_y" else wmb) for k in KEYS]))
    m16n, cmn, m4n = (t.cpu().numpy() for t in (a6[1], a6[3], a6[2]))
    lv = [got6[k].cpu().numpy() for k in ("i16dc", "i16ac", "lv4")]
    work = {  # (bytes, int32 operations) of each band function on these inputs
        "wavefront_i16_levels_band": (nbytes(*a1[:5], *top, *got1),
                                      k1_ops(qp, qpc, m16n, cmn)),
        "wavefront_chroma_band": (nbytes(*a7[:3], *top7, *got7), chroma_ops(qpc, cmn)),
        "wavefront_mixed_band": (nbytes(*a6[:6], *top6.values(), *(got6[k] for k in KEYS))
                                 + TABLES.nbytes,
                                 i16_luma_ops(qp, m16n) + i4x4_ops(qp, m4n)
                                 + cavlc_size_ops(*lv) + m16n.size * (16 * 8 + 100))}
    times = {}
    if time_it:
        def check6(out):
            if err6(out):
                raise AssertionError(f"K6-band != plain in a timed call at qp{qp}")

        times = {"wavefront_i16_levels_band": (kernel_ms(
                     torch, lambda: i16_band(*a1), 20, same_as(torch, want1, "K1t-band")),
                     plain1_ms),
                 "wavefront_chroma_band": (kernel_ms(
                     torch, lambda: chroma_band(*a7), 20, same_as(torch, want7, "K7-band")),
                     plain7_ms),
                 "wavefront_mixed_band": (kernel_ms(
                     torch, lambda: mixed_luma_band(*a6, top6), 10, check6), plain6_ms)}
    out = {}
    for kname in BAND_KERNELS:
        bound_ms, bound_by = bound(*work[kname])
        (ms, queued_ms), plain_ms = times.get(kname, ((None, None), None))
        print(f"{kname} {W}x{H} band 1 of {BAND_TILES} ({hloc} MB rows, real halo) qp{qp}: "
              f"max_abs_err {errs[kname]} (tolerance 0, vs plain and vs the full-frame "
              "kernel's rows)"
              + (f", kernel {ms:.4f} ms (queued {queued_ms:.4f}), plain {plain_ms:.1f} ms"
                 if time_it else "")
              + f", bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        if errs[kname] != 0:
            raise AssertionError(f"{kname} kernel != plain at qp{qp}")
        out[kname] = (errs[kname], ms, plain_ms, bound_ms, bound_by, queued_ms)
    print(f"K6-band qp{qp}: {int(got6['choice4'].sum())} I4x4 MBs of {m16n.size}", flush=True)
    return out


def band_stage_times(torch, dev, frame):
    """Device ms of each stage of band 1 of BAND_TILES of one 1080p frame
    (CUDA events), all-I16 and mixed, as parallel/tile.py runs them: the
    mode decision with the source row above, the band kernels with band
    0's last rows as their halo, the entropy with band 0's nC state."""
    from h264_fer_tpu_torch.codec.entropy import (chroma_setup, i16_slice_entropy,
                                                  mixed_slice_entropy)
    from h264_fer_tpu_torch.kernels.wavefront_i16 import chroma_band, i16_band
    from h264_fer_tpu_torch.kernels.wavefront_mixed import TOP_KEYS, mixed_luma_band
    from h264_fer_tpu_torch.ops.intra import INTRA16_TO_CHROMA_MODE
    from h264_fer_tpu_torch.ops.transform import chroma_qp
    from h264_fer_tpu_torch.parallel import tile

    qpc, wmb, hloc = chroma_qp(QP), W // 16, H // 16 // BAND_TILES
    planes = [torch.from_numpy(p).to(dev) for p in frame]
    b0, b1 = ([p[n * hloc * t: n * hloc * (t + 1)] for p, n in zip(planes, (16, 8, 8))]
              for t in (0, 1))
    top_row = planes[0][16 * hloc - 1].to(torch.int32)
    out = {}
    for mode, (decide, code) in tile.MODES.items():
        halo = code(*b0, decide(b0[0], None, QP), None, None, QP, qpc)["halo"]
        ctx = tile._ctx(halo)
        dec = decide(b1[0], top_row, QP)
        m16 = dec["mode16"]
        cm = torch.from_numpy(INTRA16_TO_CHROMA_MODE).to(dev)[m16.long()]
        times = {"mode_decision": cuda_ms(torch, lambda: decide(b1[0], top_row, QP), 5)}
        if mode == "i16":
            top = (halo["recon"], halo["cb"], halo["cr"])
            _, i16dc, ac, _, _, cdc, cac = i16_band(*b1, m16, cm, QP, qpc, top)
            times["k1t_band"] = cuda_ms(torch, lambda: i16_band(*b1, m16, cm, QP, qpc, top), 5)
            times["entropy"] = cuda_ms(torch, lambda: i16_slice_entropy(
                m16, cm, i16dc, ac, cdc, cac, wmb=wmb, hmb=hloc, top_ctx=ctx), 5)
        else:
            top7, top6 = (halo["cb"], halo["cr"]), {k: halo[k] for k in TOP_KEYS}
            _, _, cdc, cac = chroma_band(*b1[1:], cm, qpc, top7)
            ch = chroma_setup(cdc, cac, wmb, hloc, ctx[2:])
            args = (b1[0], m16, dec["mode4"], cm, ch["cbp_chroma"], ch["bits"], QP, top6)
            mx = mixed_luma_band(*args)
            times["k7_band"] = cuda_ms(torch, lambda: chroma_band(*b1[1:], cm, qpc, top7), 5)
            times["chroma_setup"] = cuda_ms(
                torch, lambda: chroma_setup(cdc, cac, wmb, hloc, ctx[2:]), 5)
            times["k6_band"] = cuda_ms(torch, lambda: mixed_luma_band(*args), 5)
            ent = (mx["choice4"], m16, cm, *(mx[k] for k in (
                "i16dc", "i16ac", "lv4", "prev_flags", "rem_modes", "cbp_luma", "tc_luma")),
                cdc, cac)
            times["entropy"] = cuda_ms(torch, lambda: mixed_slice_entropy(
                *ent, wmb=wmb, hmb=hloc, top_ctx=ctx, chroma=ch), 5)
        out[mode] = times
    return out


def e2e_fps(torch, enc, frames, runs: int = 3):
    """Sorted e2e fps of `runs` encode_sequence calls of `frames`, after the
    caller's warm-up (host clock; each call returns the stream)."""
    fps = []
    for _ in range(runs):
        t0 = time.perf_counter()
        enc.encode_sequence(frames)
        fps.append(len(frames) / (time.perf_counter() - t0))
    return sorted(fps)


def capture_line(label: str, programs, name: str) -> str:
    """The capture time (warm-up and capture, host ms) of each program in
    `programs` (a dict of key → DeviceProgram), as one line."""
    caps = ", ".join(f"{key[0]}{f' n={key[7]}' if key[0] == 'ippp' else ''} "
                     f"{prog.capture_ms:.1f} ms" for key, prog in programs.items()
                     if prog.capture_ms is not None)
    return f"{label} programs captured: {caps or 'none'} on {name}"


@contextlib.contextmanager
def eager_programs():
    """Context in which the device programs made run their launches
    eagerly on the card, not as CUDA graphs: the baseline that the
    programs' replays are compared with."""
    from h264_fer_tpu_torch.codec.program import DeviceProgram

    DeviceProgram.graphs = False
    try:
        yield
    finally:
        DeviceProgram.graphs = True


def eager_beside(torch, label: str, make, frames, name: str, busy_frames: int) -> str:
    """One run of the path issuing its launches eagerly (make() returns
    the path's encoder, whose programs run eagerly under eager_programs())
    after a warm-up: its e2e fps (host clock around one encode_sequence of
    `frames`, on a fresh encoder as the session's e2e runs take it) and its
    busy share profiled over the first busy_frames frames, as one line."""
    with eager_programs():
        make().encode_sequence(frames[:2])  # warm-up
        torch.cuda.synchronize()
        enc = make()
        t0 = time.perf_counter()
        enc.encode_sequence(frames)
        fps = len(frames) / (time.perf_counter() - t0)
        wall, busy, _ = device_busy(torch, lambda: make().encode_sequence(frames[:busy_frames]))
    share = f"{100 * busy / wall:.1f} %" if busy > 0 else "not measured"
    return (f"{label} eager (eager_programs()): e2e fps {fps:.2f} (one run), device busy "
            f"{share} over {busy_frames} frames on {name}")


def same_outputs(torch, got, want, label: str) -> None:
    """Raise unless every output in `want` (a dict of tensors or lists of
    tensors) equals got's, dtype and all."""
    for key, w in want.items():
        g = got[key]
        pairs = list(zip(g, w)) if isinstance(w, (list, tuple)) else [(g, w)]
        if len(pairs) != (len(w) if isinstance(w, (list, tuple)) else 1) or any(
                a.dtype != b.dtype or not torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"{label}: program output {key} != the eager launches'")


def counted_run(fn):
    """(fn(), {wrapper: launches fn made}) over every counting wrapper."""
    from h264_fer_tpu_torch.codec.program import counters

    fns = counters()
    before = [f.launches for f in fns]
    out = fn()
    return out, {f: f.launches - b for f, b in zip(fns, before) if f.launches != b}


def check_captured(prog, eager_launches: dict, label: str) -> None:
    """Raise unless the program's replay adds the eager run's launches."""
    if prog.captured != eager_launches:
        got = {f.__name__: n for f, n in prog.captured.items()}
        want = {f.__name__: n for f, n in eager_launches.items()}
        raise AssertionError(f"{label}: a replay launches {got}, the eager run {want}")


def program_phase(torch, dev, name) -> None:
    """Phase 16: each device program's replays against the eager launches
    of the same kernels on the card, in every output (module docstring)."""
    from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig
    from h264_fer_tpu_torch.codec.gop import device_gop_ippp
    from h264_fer_tpu_torch.codec.iframe import device_i16_frame, device_mixed_frame
    from h264_fer_tpu_torch.ops.device import upload_into
    from h264_fer_tpu_torch.ops.transform import chroma_qp
    from h264_fer_tpu_torch.parallel.gop_device import GopIntraEncoder, GopIpppEncoder

    qpc = chroma_qp(QP)
    frames = content(2 * GOP_LEN + 3, W, H)

    def fresh(fs):
        return [tuple(torch.from_numpy(p).to(dev) for p in f) for f in fs]

    # the whole-GOP program: GOP_LEN frames, then a short last GOP of 3
    enc = GopIpppEncoder(W, H, QP, gop_len=GOP_LEN, device=dev)
    lane = enc.lanes[0]
    keep = ("words", "nbits", "recon")
    for n, starts in ((GOP_LEN, (0, GOP_LEN)), (3, (2 * GOP_LEN, 1))):
        prog = enc._program(lane, n)
        first = None
        for s in starts:
            with lane.queue():
                for k, slot in enumerate(("ys", "cbs", "crs")):
                    upload_into(prog.slots[slot], [f[k] for f in frames[s: s + n]])
                got = prog(keep=keep)
            if lane.stream is not None:  # the CPU in a rehearsal
                lane.stream.synchronize()
            ys, cbs, crs = zip(*fresh(frames[s: s + n]))
            out, launched = counted_run(lambda: device_gop_ippp(
                ys, cbs, crs, enc.hdr_bits[: n - 1], enc.window, QP, qpc, enc.maxdiff,
                enc.prefilter))
            want = {"words": [f["words"] for f in out["frames"]],
                    "nbits": torch.stack([f["nbits"] for f in out["frames"]]),
                    "recon": [p for f in out["frames"] for p in f["recon"]],
                    **{k: out[k] for k in ("recon_y", "recon_cb", "recon_cr", "mv")}}
            same_outputs(torch, got, want, f"GOP of {n} from frame {s}")
            check_captured(prog, launched, f"GOP of {n}")
            first = first or (got, {k: want[k] for k in keep})
        same_outputs(torch, *first, f"GOP of {n}: the first replay's payloads")
    print(f"GOP programs (n = {GOP_LEN}, 3): two replays each == the eager launches "
          "(words, nbits, every frame's reference planes, final planes and MVs; "
          "launches); the first replay's payloads kept", flush=True)
    print(capture_line("IPPP", lane.programs, name), flush=True)

    # the I16 and mixed frame programs
    for mode, frame_fn in (("i16", device_i16_frame), ("mixed", device_mixed_frame)):
        ienc = GopIntraEncoder(W, H, QP, mode=mode, device=dev)
        ilane = ienc.lanes[0]
        prog = ienc._program(ilane)
        first = None
        for f in frames[:2]:
            with ilane.queue():
                for slot, plane in zip(("y", "cb", "cr"), f):
                    upload_into(prog.slots[slot], plane)
                got = prog(keep=("words", "nbits", "recon_y"))
            if ilane.stream is not None:
                ilane.stream.synchronize()
            want, launched = counted_run(lambda: frame_fn(*fresh([f])[0], QP, qpc))
            same_outputs(torch, got, want, f"{mode} frame")
            check_captured(prog, launched, f"{mode} frame")
            first = first or (got, {k: want[k] for k in ("words", "nbits", "recon_y")})
        same_outputs(torch, *first, f"{mode} frame: the first replay's payload")
        print(capture_line(mode, ilane.programs, name), flush=True)
    print("I16 and mixed frame programs: two replays each == the eager launches (every "
          "output, launches); the first replay's payload kept", flush=True)

    # the session's IDR and P frame programs against the same encoder, eager
    cfg = EncoderConfig(qp=QP, intra_every=3, deblock=True)
    graph, eager = (Encoder(W, H, cfg, device=dev) for _ in range(2))
    for i, f in enumerate(frames[:5]):
        nal_g = graph.encode_frame(*f)
        with eager_programs():
            nal_e, launched = counted_run(lambda: eager.encode_frame(*f))
        if nal_g != nal_e:
            raise AssertionError(f"session frame {i}: the program's NAL != the eager one's")
        for a, b in zip((*graph._ref, graph._mv, graph._mb_class, graph._nz),
                        (*eager._ref, eager._mv, eager._mb_class, eager._nz)):
            if not torch.equal(a, b):
                raise AssertionError(f"session frame {i}: program state != eager state")
        kind = "idr" if graph.stats[-1]["idr"] else "p"
        prog = [p for key, p in graph._programs.items() if key[0] == kind][0]
        check_captured(prog, launched, f"session {kind} frame {i}")
    if [s["idr"] for s in graph.stats] != [True, False, False, True, False]:
        raise AssertionError(f"session frame types {[s['idr'] for s in graph.stats]}")
    print("session programs (IDR, P, P, IDR, P; intra_every 3, deblock): NAL bytes and "
          "state == the eager encoder's after every frame; launches", flush=True)
    print(capture_line("session", graph._programs, name), flush=True)

    # two lanes of the card replaying at once, against one eager lane
    for label, make, fs in (
            ("GopIpppEncoder", lambda **kw: GopIpppEncoder(W, H, QP, gop_len=4, **kw),
             frames[:16]),
            ("GopIntraEncoder", lambda **kw: GopIntraEncoder(W, H, QP, **kw), frames[:4])):
        two, one = make(devices=[dev] * 2), make(device=dev)
        s2 = two.encode_sequence(fs, keep_recon=True)
        with eager_programs():
            s1 = one.encode_sequence(fs, keep_recon=True)
        if s2 != s1 or any(not torch.equal(a, b) for r2, r1 in zip(two.recon, one.recon)
                           for a, b in zip(r2, r1)) or len(two.recon) != len(fs):
            raise AssertionError(f"{label} on two lanes != one eager lane")
        if any(len(lane.programs) != 1 for lane in two.lanes):
            raise AssertionError(f"{label}: a lane holds {[len(l.programs) for l in two.lanes]}")
    print("two lanes of one card (GopIpppEncoder: 4 GOPs of 4, GopIntraEncoder: 4 frames), "
          f"replaying at once == one eager lane (streams, every frame's planes) on {name}",
          flush=True)


def multi_device_configs(dev, distinct: bool):
    """The multi-device phase's 1080p configurations: (label, path whose
    one-device stream it must equal, encoder maker, entries per config).
    distinct: on cuda:0..n-1 in place of n entries of `dev`."""
    from h264_fer_tpu_torch.parallel.gop_device import GopIntraEncoder, GopIpppEncoder
    from h264_fer_tpu_torch.parallel.tile import GopTileIntraEncoder, TileIntraEncoder

    def devs(n):
        return [f"cuda:{i}" for i in range(n)] if distinct else [dev] * n

    return [
        ("i16 4 bands", "all-intra", 4, lambda: TileIntraEncoder(W, H, QP, devices=devs(4))),
        ("i16 3 uneven bands", "all-intra", 3,
         lambda: TileIntraEncoder(W, H, QP, devices=devs(3))),
        ("mixed 3 uneven bands", "mixed", 3,
         lambda: TileIntraEncoder(W, H, QP, devices=devs(3), mode="mixed")),
        ("(gop 2, tile 2) i16", "all-intra", 4,
         lambda: GopTileIntraEncoder(W, H, QP, 2, 2, devices=devs(4))),
        ("GopIntraEncoder x2", "all-intra", 2,
         lambda: GopIntraEncoder(W, H, QP, devices=devs(2))),
        ("GopIpppEncoder x2", "IPPP", 2,
         lambda: GopIpppEncoder(W, H, QP, gop_len=GOP_LEN, devices=devs(2))),
    ]


def multi_device_phase(torch, dev, name, to_decode):
    """Drive the multi-device encoders at 1080p on n entries of the card
    (and on cuda:0..n-1 where the machine has n cards): each stream must
    equal the one-device stream of the same frames (to_decode[path][0]),
    the band encoders' recon must decode from it through decode_gate, and
    the band kernels' launch counts (set to 0 just before each checked run)
    must be one per band per frame. Prints each configuration's median e2e
    fps of 3 runs after a warm-up, the profiled busy share of 2 frames in 4
    bands, the band stage times, measure_scaling at 1, 2 and 4 entries;
    checks the QCIF band streams against TILE_DIGESTS and a two-process
    gloo encode against the one-process stream. Returns the band kernels'
    launches {name: n}."""
    import os
    import socket
    import tempfile

    from h264_fer_tpu_torch.kernels.wavefront_i16 import chroma_band, i16_band
    from h264_fer_tpu_torch.kernels.wavefront_mixed import mixed_luma_band
    from h264_fer_tpu_torch.parallel.gop_device import (GopIpppEncoder, measure_scaling,
                                                        scaling_frames)

    counted = {"wavefront_i16_levels_band": i16_band, "wavefront_chroma_band": chroma_band,
               "wavefront_mixed_band": mixed_luma_band,
               **{fn.__name__: fn for fn in (*k10_counted(), *k11_counted())}}
    totals = dict.fromkeys(counted, 0)
    frames = {"all-intra": content(N_FRAMES, W, H), "mixed": content(N_FRAMES, W, H),
              "IPPP": content(N_IPPP, W, H)}
    for label, path, n, make in multi_device_configs(dev, False):
        make().encode_sequence(frames[path][:2])  # warm-up: allocator, library loads
        torch.cuda.synchronize()
        enc = make()  # TileIntraEncoder counts idr_pic_id over its life
        for fn in counted.values():
            fn.launches = 0
        tiled = hasattr(enc, "hloc")
        stream = (enc.encode_sequence(frames[path], keep_recon=True) if tiled
                  else enc.encode_sequence(frames[path]))
        got = {k: fn.launches for k, fn in counted.items()}
        n_bands = n // getattr(enc, "n_gop", 1) if tiled else 0
        want = {k: 0 for k in counted}
        if tiled:
            keys = (("wavefront_chroma_band", "wavefront_mixed_band") if enc.mode == "mixed"
                    else ("wavefront_i16_levels_band",))
            want.update({k: N_FRAMES * n_bands for k in keys})
            slices = N_FRAMES * n_bands  # K10: one slice entropy per band; K11 one decision
            want.update(k10_launches({"chroma": slices, "mixed": slices} if enc.mode == "mixed"
                                     else {"i16": slices}))
            want.update(k11_launches({"full" if enc.mode == "mixed" else "i16": slices}))
        elif path == "IPPP":
            n_gops = len(frames[path]) // GOP_LEN
            want.update(k10_launches({"i16": n_gops, "p": len(frames[path]) - n_gops}))
            want.update(k11_launches({"i16": n_gops}))
        else:
            want.update(k10_launches({"i16": len(frames[path])}))
            want.update(k11_launches({"i16": len(frames[path])}))
        if got != want:
            raise AssertionError(f"{label}: band launches {got}, expected {want}")
        for k in totals:
            totals[k] += got[k]
        if stream != to_decode[path][0]:
            raise AssertionError(f"{label}: stream != the one-device {path} stream")
        if tiled:
            recon = [tuple(torch.from_numpy(p) for p in f) for f in enc.recon]
            decode_gate(torch, dev, f"{label} recon", stream, recon,
                        {"spec_mode": True} if enc.mode == "mixed" else {}, name, timed=False)
        fps = e2e_fps(torch, enc, frames[path])
        print(f"multi-device {label} on {n} entries of {dev}: {len(frames[path])} frames "
              f"{W}x{H} QP{QP}, stream == one-device {path} stream"
              + (", recon == decode" if tiled else "") + f", band launches {got}; e2e fps "
              f"median {fps[1]:.2f} (runs {', '.join(f'{v:.2f}' for v in fps)}) on {name}",
              flush=True)
    make = multi_device_configs(dev, False)[0][3]  # i16 in 4 bands
    wall, busy, top = device_busy(torch, lambda: make().encode_sequence(frames["all-intra"][:2]))
    if busy > 0:
        print(f"profiled 2-frame encode in 4 bands: wall {wall:.1f} ms, kernels {busy:.1f} ms, "
              f"device busy {100 * busy / wall:.1f} % on {name}", flush=True)
        for key, ms_k, count in top:
            print(f"  {ms_k:8.3f} ms  {count:6d} x  {key[:90]}")
    else:
        print("device busy share: not measured (the profiler saw no device time)")
    if torch.cuda.device_count() > 1:
        for label, path, n, make in multi_device_configs(dev, True):
            if n <= torch.cuda.device_count():
                if make().encode_sequence(frames[path]) != to_decode[path][0]:
                    raise AssertionError(f"{label} on distinct cards: stream != one-device")
                print(f"multi-device {label} on cuda:0..{n - 1}: stream == one-device "
                      f"{path} stream", flush=True)
    else:
        print("multi-device on distinct cards: not run (one card)", flush=True)
    for mode, times in band_stage_times(torch, dev, content(1, W, H)[0]).items():
        print(f"band stages, {mode} (device ms, band 1 of {BAND_TILES}, one frame): "
              + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
              + f", sum {sum(times.values()):.3f} on {name}", flush=True)
    scaling = measure_scaling(W, H, QP, device_counts=(1, 2, 4), devices=[dev] * 4)
    print("measure_scaling (GopIntraEncoder, 8 frames, best of 2 after a warm-up) on "
          f"1, 2, 4 entries of {dev}: "
          + ", ".join(f"{k}: {v:.2f} fps" for k, v in scaling.items()) + f" on {name}",
          flush=True)
    t0 = time.perf_counter()
    tile = tile_qcif_streams(dev)
    for key, s in tile.items():
        if hashlib.sha256(s).hexdigest() != TILE_DIGESTS[key]:
            raise AssertionError(f"QCIF band stream {key} != its JAX digest")
    print(f"QCIF band streams {sorted(tile)} == their JAX digests "
          f"({time.perf_counter() - t0:.1f} s) on {name}", flush=True)
    # two gloo processes on the card, QCIF, GOPs of 2
    t0 = time.perf_counter()
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "proc0.264"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "h264_fer_tpu_torch.parallel.dist", str(out), "2",
             "--size", "176x144", "--frames", "6", "--qp", str(QP)],
            cwd=repo_file("."), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, H264_COORD_ADDR=f"127.0.0.1:{port}", H264_NUM_PROCS="2",
                     H264_PROC_ID=str(i))) for i in range(2)]
        try:
            logs = [p.communicate(timeout=240)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise AssertionError(f"gloo process failed:\n{log[-2000:]}")
        got = out.read_bytes()
    want = GopIpppEncoder(176, 144, QP, gop_len=2, device=dev).encode_sequence(
        scaling_frames(176, 144, 6))
    if got != want:
        raise AssertionError("two-process gloo encode != one-process encode")
    print(f"two gloo processes on {dev}: QCIF, 6 frames, GOPs of 2, {len(got)} bytes == "
          f"one-process stream ({time.perf_counter() - t0:.1f} s) on {name}", flush=True)
    return totals


P_BAND_TILES = 4  # K4-band's checks: band 1 of 4 bands of 17 MB rows at 1080p
# K13's bands in check_k12_k13, (bands, band): the P-band paths' band 1 of
# 4, and bands 1 of 3 and 4 of 6, whose rows K13's grid splits unevenly
# (band 4 of 6 has fewer rows than the card holds blocks: a block a row)
K13_BANDS = ((P_BAND_TILES, 1), (3, 1), (6, 4))
P_BAND_KERNELS = ("interp", "me_int", "me_qpel", "wavefront_p_band", "mc", "residual_recon")


def band_rows(name: str, out, r0: int, hl: int, wmb: int, ext: int = WINDOW + 2) -> list:
    """The rows of MB rows [r0, r0 + hl) of a frame's K13, K2-K5 or K12
    output, as a list of tensors: K13's planes with their ext rows above
    and below, K2's and K3's per 8x8 block, K4's per MB (DECIDE_KEYS
    order), K5's per sample, K12's levels per MB and recon per sample."""
    if name == "interp":
        return [out[:, 16 * r0: 16 * (r0 + hl) + 2 * ext]]
    if name == "residual_recon":
        levels, *recon = out
        mbs = slice(wmb * r0, wmb * (r0 + hl))
        return [levels["luma"][mbs], levels["cdc"][:, mbs], levels["cac"][:, mbs],
                *(p[n * r0: n * (r0 + hl)] for p, n in zip(recon, (16, 8, 8)))]
    if name in ("me_int", "me_qpel"):
        blk = slice(4 * wmb * r0, 4 * wmb * (r0 + hl))
        return [x[blk] for x in kernel_outputs(out)]
    if name == "mc":
        return [p[n * r0: n * (r0 + hl)] for p, n in zip(out, (16, 8, 8))]
    return [x[wmb * r0: wmb * (r0 + hl)] for x in kernel_outputs(out)]


def band_reference(ref, t: int, n_tile: int, window: int = WINDOW):
    """Band t of n_tile's (ref_y, ref_cb, ref_cr, prev_mv) as
    parallel/tile_p.py builds it from a frame's reference ref: each plane's
    band rows between real rows of the bands above and below (their edge
    rows repeated at the frame's edges), prev_mv's rows of the band."""
    from h264_fer_tpu_torch.parallel.tile_p import _window

    ext = window + 2
    wmb, hl = ref[0].shape[1] // 16, ref[0].shape[0] // 16 // n_tile
    wins = []
    for p, n, vh in zip(ref[:3], (16, 8, 8), (ext + 4, ext // 2 + 2, ext // 2 + 2)):
        bands = [p[n * hl * b: n * hl * (b + 1)] for b in range(n_tile)]
        wins.append(_window(bands[t], bands[t - 1] if t else None,
                            bands[t + 1] if t + 1 < n_tile else None, vh, p.device))
    return (*wins, ref[3][wmb * hl * t: wmb * hl * (t + 1)])


def check_p_band(torch, label, ref, src, prev_mv, qp, n_tile, t, time_it=False,
                 blocks=()):
    """K4-band kernel vs plain twin on band t of n_tile of one frame pair
    (card planes ref / src, prev_mv the previous frame's MVs), with a real
    halo: the frame K4's final MVs and types of the MB row above, as the
    frame kernel leaves them. K13's band form, K2, K3, K4-band, K5 and K12
    on the band's inputs, each held to its plain twin, must also equal the
    frame kernels' rows of the band (K13: the frame planes' rows); K4-band
    also with its grid forced to `blocks`. Returns (K4-band's
    (max_abs_err, ms, plain_ms, bound_ms, bound_by, queued_ms), times None
    unless time_it, every timed call held to the plain output; with
    time_it the band's stages with the kernels (fns, args) of
    p_frame_stages, else None; {stage: max_abs_err})."""
    from h264_fer_tpu_torch.kernels.wavefront_p import MB_SKIP, pframe_decide_band

    h, w = src[0].shape
    wmb, hl = w // 16, h // 16 // n_tile
    r0 = t * hl
    kern = p_kernels(plain=False)
    _, _, frame = p_frame_stages(torch, kern, src, (*ref, prev_mv), qp)
    top = None
    if t:
        row = slice(wmb * (r0 - 1), wmb * r0)
        full = frame["wavefront_p"]
        top = (full["mv"][row],
               torch.where(full["skip"][row], MB_SKIP, full["mb_type"][row]).to(torch.int32))
    band_src = tuple(p[n * r0: n * (r0 + hl)] for p, n in zip(src, (16, 8, 8)))
    band_ref = band_reference((*ref, prev_mv), t, n_tile)
    plain, args, outs = p_frame_stages(torch, p_kernels(plain=True), band_src, band_ref, qp,
                                       band=True, top=top)
    errs = {}
    for name in P_BAND_KERNELS:
        got = kernel_outputs(stage_fn(kern, name, band=True)(*args[name]))
        torch.cuda.synchronize()
        rows = band_rows(name, frame["wavefront_p" if name == "wavefront_p_band" else name],
                         r0, hl, wmb)
        errs[name] = max(max_err(torch, got, kernel_outputs(outs[name])),
                         max_err(torch, got, rows))
        if name == "me_int":  # its other forms on the band's inputs
            errs[name] = max(errs[name], check_k2_forms(torch, args[name][:5]))
    want = kernel_outputs(outs["wavefront_p_band"])
    a = args["wavefront_p_band"]
    for b in blocks:
        err_b = max_err(torch, kernel_outputs(pframe_decide_band(*a, blocks=b)), want)
        print(f"wavefront_p_band {label} band {t} of {n_tile} qp{qp} grid of {b} blocks: "
              f"max_abs_err {err_b}", flush=True)
        errs["wavefront_p_band"] = max(errs["wavefront_p_band"], err_b)
    ms = plain_ms = queued_ms = stages = None
    if time_it:
        def check(o):
            if max_err(torch, kernel_outputs(o), want):
                raise AssertionError(f"K4-band != plain in a timed call at {label} qp{qp}")
        ms, queued_ms = kernel_ms(torch, lambda: pframe_decide_band(*a), 20, check)
        plain_ms = timed_once(torch, lambda: plain["wavefront_p_band"](*a))[1]
        stages = p_frame_stages(torch, kern, band_src, band_ref, qp, band=True, top=top)[:2]
    bound_ms, bound_by = bound(*p_work(torch, args, outs, "wavefront_p_band")["wavefront_p_band"])
    print(f"P band {label} band {t} of {n_tile} ({hl} MB rows, real halo) qp{qp}: max_abs_err "
          + ", ".join(f"{k} {v}" for k, v in errs.items())
          + " (tolerance 0, vs plain and vs the frame's rows)"
          + (f"; K4-band {ms:.4f} ms (queued {queued_ms:.4f}), plain {plain_ms:.1f} ms"
             if time_it else "")
          + f", K4-band bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    if any(errs.values()):
        raise AssertionError(f"P band {label} band {t} qp{qp}: {errs}")
    return (errs["wavefront_p_band"], ms, plain_ms, bound_ms, bound_by, queued_ms), stages, errs


def p_band_configs(dev):
    """The P-band phase's 1080p configurations on entries of `dev`: (label,
    entries, bands, encoder maker)."""
    from h264_fer_tpu_torch.parallel.tile_p import GopTileIpppEncoder, TileIpppEncoder

    return [
        ("IPPP 4 bands", 4, 4,
         lambda: TileIpppEncoder(W, H, QP, gop_len=GOP_LEN, devices=[dev] * 4)),
        ("IPPP 2 bands", 2, 2,
         lambda: TileIpppEncoder(W, H, QP, gop_len=GOP_LEN, devices=[dev] * 2)),
        ("(gop 2, tile 2) IPPP", 4, 2,
         lambda: GopTileIpppEncoder(W, H, QP, GOP_LEN, 2, 2, devices=[dev] * 4)),
    ]


def tile_p_qcif_streams(dev) -> dict:
    """{name: stream} of the P-band QCIF streams: N_TILE_P_QCIF frames of the
    clip through TileIpppEncoder(qp, gop_len=4) in 3 bands on `dev`."""
    from h264_fer_tpu_torch.parallel.tile_p import TileIpppEncoder
    from h264_fer_tpu_torch.vio.y4m import Y4MReader

    clip = list(Y4MReader(str(repo_file(HOST_CLIP))))[:N_TILE_P_QCIF]
    return {key: TileIpppEncoder(176, 144, qp, gop_len=4, devices=[dev] * 3).encode_sequence(clip)
            for key, qp in (("qp28", 28), ("qp40", 40))}


def p_band_phase(torch, dev, name, to_decode):
    """The P-frame bands: K4-band (and K13, K2, K3, K5 and K12 on band
    inputs) held against plain and the frame kernels' rows at 1080p (QP 28,
    40, 46) and on QCIF in 3 bands; then TileIpppEncoder in 4 and 2 bands
    and GopTileIpppEncoder (2, 2) at 1080p on entries of the card, each
    with the launch counts set to 0 just before (one K13, K2, K3, K4-band,
    K5 and K12 per band per P frame, one K1t-band per band per IDR, no
    frame K4 or K1t):
    each stream must equal the one-device IPPP stream of phase 5 and the
    bands' reference planes must decode from it (decode_gate, spec mode,
    untimed). Prints the median e2e fps of 3 after a warm-up, the device
    ms of each stage of one band's P frame and the profiled busy share of 4
    frames in 4 bands; checks the QCIF band streams
    against TILE_P_DIGESTS. Returns ({qp: K4-band's check tuple}, the
    launches of K4-band, K2, K12 and K13 over the configurations, and K12's
    and K13's largest band error)."""
    from h264_fer_tpu_torch.kernels.interp import interp_planes
    from h264_fer_tpu_torch.kernels.mc import mc_bulk
    from h264_fer_tpu_torch.kernels.me_int import integer_score_map
    from h264_fer_tpu_torch.kernels.me_qpel import qpel_refine_maps
    from h264_fer_tpu_torch.kernels.residual_p import residual_recon
    from h264_fer_tpu_torch.kernels.wavefront_i16 import i16_band, i16_frame
    from h264_fer_tpu_torch.kernels.wavefront_p import pframe_decide, pframe_decide_band

    band_errs = {"interp": 0, "residual_recon": 0}

    def keep(errs):
        for k in band_errs:
            band_errs[k] = max(band_errs[k], errs[k])

    # 1080p: frame 2 from frame 1 with frame 1's MVs (phase 4's chained pair)
    pair = [tuple(torch.from_numpy(p).to(dev) for p in f) for f in content(3, W, H)]
    nmb = (W // 16) * (H // 16)
    zero = torch.zeros((nmb, 4, 2), dtype=torch.int32, device=dev)
    k4b, stages = {}, None
    for qp in P_QPS:
        mv1 = p_frame_stages(torch, p_kernels(plain=False), pair[1], (*pair[0], zero),
                             qp)[2]["wavefront_p"]["mv"]
        k4b[qp], band_stages, errs = check_p_band(torch, f"{W}x{H}", pair[1], pair[2], mv1,
                                                  qp, P_BAND_TILES, 1, time_it=qp == QP)
        keep(errs)
        if qp == QP:
            stages = band_stages
    # QCIF in 3 bands: random previous MVs beyond the search limit
    rng = np.random.default_rng(SEED + 1)
    lim = 4 * (WINDOW + 2) - 4
    qcif = [tuple(torch.from_numpy(p).to(dev) for p in f) for f in content(2, 176, 144)]
    for qp in P_QPS:
        prev = torch.from_numpy(rng.integers(-lim - 4, lim + 5, (99, 4, 2))
                                .astype(np.int32)).to(dev)
        for t in range(3):
            k4, _, errs = check_p_band(torch, "176x144 random MVs", *qcif, prev, qp, 3, t,
                                       blocks=(1, 3) if qp == QP else ())
            k4b[qp] = (max(k4b[qp][0], k4[0]), *k4b[qp][1:])
            keep(errs)
    fns, args = stages  # the entropy here without its band contexts (a few more ops)
    times = {k: cuda_ms(torch, lambda k=k: fns[k](*args[k]), 5) for k in args}
    print(f"P band stages (device ms, band 1 of {P_BAND_TILES}, one P frame): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f", sum {sum(times.values()):.3f} on {name}", flush=True)

    counted = {"pframe_decide_band": pframe_decide_band, "integer_score_map": integer_score_map,
               "qpel_refine_maps": qpel_refine_maps, "mc_bulk": mc_bulk, "i16_band": i16_band,
               "pframe_decide": pframe_decide, "i16_frame": i16_frame,
               "residual_recon": residual_recon, "interp_planes": interp_planes,
               **{fn.__name__: fn for fn in (*k10_counted(), *k11_counted())}}
    frames = content(N_IPPP, W, H)
    n_gops = N_IPPP // GOP_LEN
    n_p = N_IPPP - n_gops
    launches = dict.fromkeys(("pframe_decide_band", "integer_score_map", "residual_recon",
                              "interp_planes"), 0)
    for label, n, n_tile, make in p_band_configs(dev):
        make().encode_sequence(frames[:2])  # warm-up: allocator, library loads
        torch.cuda.synchronize()
        enc = make()
        for fn in counted.values():
            fn.launches = 0
        stream = enc.encode_sequence(frames, keep_recon=True)
        got = {k: fn.launches for k, fn in counted.items()}
        want = {k: n_p * n_tile for k in ("pframe_decide_band", "integer_score_map",
                                          "qpel_refine_maps", "mc_bulk", "residual_recon",
                                          "interp_planes")}
        want.update(i16_band=n_gops * n_tile, pframe_decide=0, i16_frame=0,
                    **k10_launches({"i16": n_gops * n_tile, "p": n_p * n_tile}),
                    **k11_launches({"i16": n_gops * n_tile}))
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        for k in launches:
            launches[k] += got[k]
        if stream != to_decode["IPPP"][0]:
            raise AssertionError(f"{label}: stream != the one-device IPPP stream")
        recon = [tuple(torch.from_numpy(p) for p in f) for f in enc.recon]
        decode_gate(torch, dev, f"{label} reference planes", stream, recon,
                    {"spec_mode": True}, name, timed=False)
        fps = e2e_fps(torch, enc, frames)
        print(f"P bands {label} on {n} entries of {dev}: {N_IPPP} frames {W}x{H} QP{QP} GOP "
              f"{GOP_LEN}, stream == one-device IPPP stream, reference planes == decode, "
              f"launches {got}; e2e fps median {fps[1]:.2f} "
              f"(runs {', '.join(f'{v:.2f}' for v in fps)}) on {name}", flush=True)
    make = p_band_configs(dev)[0][3]  # 4 bands
    wall, busy, top = device_busy(torch, lambda: make().encode_sequence(frames[:4]))
    if busy > 0:
        print(f"profiled 4-frame IPPP encode (IDR + 3 P) in 4 bands: wall {wall:.1f} ms, "
              f"kernels {busy:.1f} ms, device busy {100 * busy / wall:.1f} % on {name}", flush=True)
        for key, ms_k, count in top:
            print(f"  {ms_k:8.3f} ms  {count:6d} x  {key[:90]}")
    else:
        print("device busy share: not measured (the profiler saw no device time)")
    t0 = time.perf_counter()
    qcif_streams = tile_p_qcif_streams(dev)
    for key, s in qcif_streams.items():
        if hashlib.sha256(s).hexdigest() != TILE_P_DIGESTS[key]:
            raise AssertionError(f"QCIF P-band stream {key} != its JAX digest")
    print(f"QCIF P-band streams {sorted(qcif_streams)} == their JAX digests "
          f"({time.perf_counter() - t0:.1f} s) on {name}", flush=True)
    return k4b, launches, band_errs


def repo_file(rel: str) -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent / rel


def qcif_clip(n: int) -> list:
    """The first n frames of the QCIF clip HOST_CLIP, (y, cb, cr) uint8."""
    from h264_fer_tpu_torch.vio.y4m import Y4MReader

    return list(Y4MReader(str(repo_file(HOST_CLIP))))[:n]


def check_device_qcif(key: str, on_card: bytes, on_cpu: bytes) -> None:
    """Raise unless the one-device QCIF stream `key` from the card equals
    the CPU path's and has the SHA-256 DEVICE_DIGESTS gives it."""
    if on_card != on_cpu:
        raise AssertionError(f"QCIF {key} stream on the card != CPU path stream")
    digest = hashlib.sha256(on_card).hexdigest()
    if digest != DEVICE_DIGESTS[key]:
        raise AssertionError(f"QCIF {key} stream: SHA-256 {digest} != the JAX "
                             f"package's {DEVICE_DIGESTS[key]}")


def host_qcif_streams(dev) -> dict:
    """The host path's QCIF streams on `dev`: "intra_qp28" (all-intra, QP 28,
    3 frames of the clip) and every HOST_QCIF stream (N_HOST_QCIF frames),
    each as (stream, the encoder's reconstruction of its last frame). Each
    encode runs with K11's counts set to 0 just before: one full-form launch
    per IDR where it takes device modes on a card, none otherwise."""
    from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig
    from h264_fer_tpu_torch.vio.y4m import Y4MReader

    clip = list(Y4MReader(str(repo_file(HOST_CLIP))))[:N_HOST_QCIF]
    cases = {"intra_qp28": ({"qp": 28, "intra_every": 1}, {}), **HOST_QCIF}
    out = {}
    for name, (cfg, kw) in cases.items():
        enc = Encoder(176, 144, EncoderConfig(**cfg), iframe="host", pframe="host",
                      device=dev, **kw)
        for fn in k11_counted():
            fn.launches = 0
        stream = enc.encode_sequence(clip[:3] if name == "intra_qp28" else clip)
        on_card = kw.get("device_modes") and str(dev).startswith("cuda")
        want = k11_launches({"full": sum(st["idr"] for st in enc.stats) if on_card else 0})
        if {fn.__name__: fn.launches for fn in k11_counted()} != want:
            raise AssertionError(f"host QCIF {name} on {dev}: K11 launches "
                                 f"{[fn.launches for fn in k11_counted()]}, expected {want}")
        out[name] = (stream, enc.reconstructed())
    return out


def tile_qcif_streams(dev) -> dict:
    """{name: stream} of TILE_QCIF: the clip's first frames through
    TileIntraEncoder on `dev` (one entry per band)."""
    from h264_fer_tpu_torch.parallel.tile import TileIntraEncoder
    from h264_fer_tpu_torch.vio.y4m import Y4MReader

    clip = list(Y4MReader(str(repo_file(HOST_CLIP))))[:N_TILE_QCIF]
    return {name: TileIntraEncoder(176, 144, QP, devices=[dev] * n,
                                   mode=mode).encode_sequence(clip)
            for name, (mode, n) in TILE_QCIF.items()}


def check_host_qcif(streams: dict, where: str) -> None:
    """Raise unless the host all-intra stream is the prefix of the C++
    reference's and every HOST_QCIF stream has its HOST_DIGESTS digest."""
    ref = repo_file(HOST_REF).read_bytes()
    intra = streams["intra_qp28"][0]
    if not ref.startswith(intra):
        raise AssertionError(f"host all-intra QCIF stream on {where} is not a prefix "
                             "of the C++ reference encoder's")
    for name in HOST_QCIF:
        digest = hashlib.sha256(streams[name][0]).hexdigest()
        if digest != HOST_DIGESTS[name]:
            raise AssertionError(f"host QCIF {name} on {where}: SHA-256 {digest} != the "
                                 f"JAX host Encoder's {HOST_DIGESTS[name]}")


def host_path(torch, dev, frames):
    """Phase 10's 1080p run: the host path on `frames`, with K8's, K11's,
    K12's and K13's counts set to 0 just before (no K11 launch: its modes
    come from the host; one K13 a P frame, for its planes; no K12); the
    stream must parse back. Returns (stream, the reference planes after
    each frame on the card, the K8 and K13 launches, the
    state of the last K8 call (planes and syntax state before its filter),
    per frame the seconds of the whole frame and of K8's synchronised call,
    and the encoder's per-frame stats)."""
    from h264_fer_tpu_torch.codec import encoder_host
    from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig
    from h264_fer_tpu_torch.kernels.deblock import deblock_frame
    from h264_fer_tpu_torch.kernels.interp import interp_planes
    from h264_fer_tpu_torch.kernels.residual_p import residual_recon

    cfg = EncoderConfig(qp=QP, intra_every=SESSION_INTRA_EVERY, deblock=True)
    enc = Encoder(W, H, cfg, iframe="host", pframe="host", device=dev)
    k8_s, last_state = [], []

    def timed_k8(*args):
        last_state[:] = args[:6]
        t0 = time.perf_counter()
        out = deblock_frame(*args)
        torch.cuda.synchronize()
        k8_s.append(time.perf_counter() - t0)
        return out

    recon, frame_s = [], []
    torch.cuda.synchronize()
    for fn in (deblock_frame, interp_planes, residual_recon, *k11_counted()):
        fn.launches = 0
    with mock.patch.object(encoder_host, "deblock_frame", timed_k8):
        stream = enc.headers()
        for f in frames:
            t0 = time.perf_counter()
            stream += enc.encode_frame(*f)
            frame_s.append(time.perf_counter() - t0)
            recon.append(tuple(torch.from_numpy(p).to(dev) for p in enc.reconstructed()))
    launches = {"deblock_frame": deblock_frame.launches,
                "interp_planes": interp_planes.launches}
    if any(fn.launches for fn in k11_counted()):  # its modes come from the host
        raise AssertionError("host path: K11 launched")
    n_p = sum(not st["idr"] for st in enc.stats)
    if interp_planes.launches != n_p or residual_recon.launches:
        raise AssertionError(f"host path: {interp_planes.launches} K13 launches for {n_p} P "
                             f"frames, {residual_recon.launches} K12")
    parse_session_stream(stream, enc.stats, W, H, QP)
    return stream, recon, launches, tuple(last_state), frame_s, k8_s, enc.stats


TOPK = 16  # the device ME candidates per 8x8 block (--tpu-me, encoder_host.ME_TOPK)


def check_me_topk(torch, label, src, ref, time_it=False, window=WINDOW, topk=TOPK):
    """K2 (metric 0, ext = window) + K9 against the plain chain (K2's and
    K9's plain twins, on the card), bit-exact: ops/me.full_search_topk of
    src against ref ((H, W) uint8 on the card). With time_it, times K9 on
    K2's map both ways (kernel_ms, every timed call held to plain), its
    plain twin (a stable sort) and, as the library's yardstick, one
    torch.topk(map, topk, largest=False) call (timed only: its order of
    ties is not K9's). Returns ((max_abs_err, ms, plain_ms, bound_ms,
    bound_by, queued_ms, library_ms), the plain candidates)."""
    from h264_fer_tpu_torch.kernels.me_int import integer_score_map, integer_score_map_plain
    from h264_fer_tpu_torch.kernels.me_topk import topk_candidates, topk_candidates_plain
    from h264_fer_tpu_torch.ops.interp import edge_pad
    from h264_fer_tpu_torch.ops.me import full_search_topk

    plane0 = edge_pad(ref, window).contiguous()
    want = topk_candidates_plain(integer_score_map_plain(src, plane0, window, window, 0),
                                 window, topk)
    err = max_err(torch, full_search_topk(src, ref, window, topk), want)
    smap = integer_score_map(src, plane0, window, window, 0)
    err = max(err, max_err(torch, topk_candidates(smap, window, topk), want),
              check_k2_forms(torch, (src, plane0, window, window, 0)))
    torch.cuda.synchronize()
    ms = plain_ms = queued_ms = lib_ms = None
    if time_it:
        ms, queued_ms = kernel_ms(torch, lambda: topk_candidates(smap, window, topk), 20,
                                  same_as(torch, want, f"me_topk {label}"))
        plain_ms = cuda_ms(torch, lambda: topk_candidates_plain(smap, window, topk), 5)
        lib_ms = cuda_ms(torch, lambda: torch.topk(smap, topk, dim=1, largest=False), 20)
    # each map entry read once, each candidate written once; at least one
    # comparison per entry
    bound_ms, bound_by = bound(nbytes(smap, *want), smap.numel())
    print(f"me_topk {label} window {window} topk {topk}: max_abs_err {err} (tolerance 0)"
          + (f", kernel {ms:.4f} ms (queued {queued_ms:.4f}), plain {plain_ms:.3f} ms, "
             f"torch.topk {lib_ms:.4f} ms" if time_it else "")
          + f", bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    if err != 0:
        raise AssertionError(f"K2 + K9 != the plain chain at {label}")
    return (err, ms, plain_ms, bound_ms, bound_by, queued_ms, lib_ms), want


def k9_rows(window: int, rng) -> np.ndarray:
    """Adversarial (n, S*S) int32 rows for K9 at `window`: rows whose range
    sits exactly at the limit of K9's 32-bit keys (2^(32 - sbits) - 1,
    sbits = ceil(log2(S*S))) and a step above it (64-bit keys), rows of one
    value (0, -7, the int32 extremes), and rows whose least scores all lie
    in one lane's shifts l + 32 k (lanes 0, 31 and one at random;
    descending in k, ties in pairs; once more shifted negative), so that
    one lane pops until its list is empty."""
    ss = (2 * window + 1) ** 2
    lim = (1 << (32 - (ss - 1).bit_length())) - 1
    rows = []
    if ss > 1:
        for step in (0, 1):
            base = int(rng.integers(-2**31, 2**31 - 1 - lim - step))
            row = base + rng.integers(0, lim + 1, ss)
            ends = rng.choice(ss, 2, replace=False)
            row[ends[0]], row[ends[1]] = base, base + lim + step
            rows.append(row)
    rows += [np.full(ss, v) for v in (0, -7, -2**31, 2**31 - 1)]
    for lane in (0, 31, int(rng.integers(32))):
        row = rng.integers(100, 16321, ss)
        own = np.arange(lane, ss, 32)
        row[own] = (len(own) - 1 - np.arange(len(own))) // 2
        rows += [row, row - 150]
    return np.stack(rows).astype(np.int32)


def k9_narrow_rows(m: np.ndarray, window: int) -> np.ndarray:
    """(n,) bool: the rows of the (n, S*S) map that K9 keys in 32 bits,
    (score - row min) << sbits | shift with sbits = ceil(log2(S*S)): those
    whose range (largest minus least score) fits in 32 - sbits bits. The
    others take 64-bit keys."""
    sbits = ((2 * window + 1) ** 2 - 1).bit_length()
    m = m.astype(np.int64)
    return m.max(1) - m.min(1) < 1 << (32 - sbits)


def check_k9_maps(torch, dev) -> int:
    """K9 alone against its plain twin on random maps with ties everywhere,
    negative scores and the int32 extremes, and on k9_rows' adversarial
    rows, at windows that pick each of the kernel's instances (4, 10 and 36
    keys per lane, 10 with S fixed at window 8's 17, and the row re-read
    every round) and topk up to the whole row. At every window but 0 (one
    shift: every row packs) some rows take each key form, 32 and 64 bits.
    Returns the largest error."""
    from h264_fer_tpu_torch.kernels.me_topk import topk_candidates, topk_candidates_plain

    rng = np.random.default_rng(SEED)
    err, forms = 0, []
    for window, topks in ((0, (1,)), (4, (4, 81)), (7, (16, 225)), (8, (1, 16, 33, 289)),
                          (16, (16, 40)), (17, (16,))):
        ss = (2 * window + 1) ** 2
        m = np.concatenate([rng.integers(-3, 4, (300, ss)), rng.integers(0, 16321, (300, ss)),
                            rng.choice([-2**31, 2**31 - 1, 0], (40, ss)),
                            k9_rows(window, rng)]).astype(np.int32)
        narrow = int(k9_narrow_rows(m, window).sum())
        m = torch.from_numpy(m).to(dev)
        forms.append(f"window {window} {narrow} / {len(m) - narrow}")
        if window and not 0 < narrow < len(m):
            raise AssertionError(f"K9's rows at window {window} take one key form only")
        for topk in topks:
            e = max_err(torch, topk_candidates(m, window, topk),
                        topk_candidates_plain(m, window, topk))
            if e:
                raise AssertionError(f"K9 != plain on a random map, window {window} topk {topk}")
            err = max(err, e)
    print(f"me_topk random and adversarial maps (rows keyed 32 / 64 bits: {', '.join(forms)}):"
          f" max_abs_err {err}", flush=True)
    return err


def me_topk_path(torch, dev, frames):
    """Phase 10's --tpu-me run at 1080p (the CLI's `encode --tpu-iframe
    --tpu-me --deblock --intra-every 8`): Encoder(..., iframe="i16",
    pframe="host", me="topk") on `frames` with the launch counts set to 0
    just before; one K1t, K2, K9 and K13 launch, K10's one for the IDR and
    one K8 per frame, no other P kernel (no K3, K4, K5 or K12); the stream
    parses with the filter signalled. Returns (stream,
    the reference planes after each frame on the card, launches, per frame
    the seconds, the encoder's stats, and the recorded (src, plane0, ext,
    window, candidates) of the P frame's search)."""
    from h264_fer_tpu_torch.codec import encoder_host
    from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig
    from h264_fer_tpu_torch.kernels.deblock import deblock_frame
    from h264_fer_tpu_torch.kernels.interp import interp_planes
    from h264_fer_tpu_torch.kernels.mc import mc_bulk
    from h264_fer_tpu_torch.kernels.me_int import integer_score_map
    from h264_fer_tpu_torch.kernels.me_qpel import qpel_refine_maps
    from h264_fer_tpu_torch.kernels.me_topk import topk_candidates
    from h264_fer_tpu_torch.kernels.residual_p import residual_recon
    from h264_fer_tpu_torch.kernels.wavefront_i16 import i16_frame, i16_recon
    from h264_fer_tpu_torch.kernels.wavefront_p import pframe_decide

    cfg = EncoderConfig(qp=QP, intra_every=SESSION_INTRA_EVERY, deblock=True)
    enc = Encoder(W, H, cfg, iframe="i16", pframe="host", me="topk", device=dev)
    searched, search = [], encoder_host.candidates

    def recorded(src, plane0, ext, window, topk):
        out = search(src, plane0, ext, window, topk)
        searched.append((src, plane0, ext, window, out))
        return out

    counted = (i16_frame, i16_recon, integer_score_map, topk_candidates, deblock_frame,
               qpel_refine_maps, pframe_decide, mc_bulk, interp_planes, residual_recon,
               *k10_counted(), *k11_counted())
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    recon, frame_s = [], []
    with mock.patch.object(encoder_host, "candidates", recorded):
        stream = enc.headers()
        for f in frames:
            t0 = time.perf_counter()
            stream += enc.encode_frame(*f)
            frame_s.append(time.perf_counter() - t0)
            recon.append(tuple(torch.from_numpy(p).to(dev) for p in enc.reconstructed()))
    launches = {fn.__name__: fn.launches for fn in counted}
    n_p = sum(not st["idr"] for st in enc.stats)
    want = {"i16_frame": len(frames) - n_p, "i16_recon": 0, "integer_score_map": n_p,
            "topk_candidates": n_p, "deblock_frame": len(frames), "qpel_refine_maps": 0,
            "pframe_decide": 0, "mc_bulk": 0, "interp_planes": n_p, "residual_recon": 0,
            **k10_launches({"i16": len(frames) - n_p}),
            **k11_launches({"i16": len(frames) - n_p})}
    if launches != want or len(searched) != n_p:
        raise AssertionError(f"--tpu-me path launches {launches} ({len(searched)} searches), "
                             f"expected {want}")
    parse_session_stream(stream, enc.stats, W, H, QP)
    return stream, recon, launches, frame_s, enc.stats, searched


K10_QCIF_GRIDS = (("176x144", 176, 144), ("64x208", 64, 208), ("16x144", 16, 144),
                  ("176x16", 176, 16))
# the tpu_entropy function each K10 form replaces, and its row in the kernels line
K10_ROWS = {"i16": ("cavlc_slice_i16", "h264_fer_tpu/codec/tpu_entropy.py:433"),
            "mixed": ("cavlc_slice_mixed", "h264_fer_tpu/codec/tpu_entropy.py:185"),
            "p": ("cavlc_slice_p", "h264_fer_tpu/codec/tpu_entropy.py:298"),
            "chroma": ("cavlc_chroma_setup", "h264_fer_tpu/codec/tpu_entropy.py:153")}
# the positions of each form's level arrays among its function's arguments
K10_LEVELS = {"i16": (2, 3, 4, 5), "mixed": (3, 4, 5, 10, 11), "p": (3, 4, 5),
              "chroma": (0, 1)}


def k10_functions():
    """{form: (K10 dispatcher, plain twin, wrapper whose .launches count it)}."""
    from h264_fer_tpu_torch.codec import entropy
    from h264_fer_tpu_torch.kernels import cavlc_slice

    return {"i16": (entropy.i16_slice_entropy, entropy.i16_slice_entropy_plain,
                    cavlc_slice.i16_entropy),
            "mixed": (entropy.mixed_slice_entropy, entropy.mixed_slice_entropy_plain,
                      cavlc_slice.mixed_entropy),
            "p": (entropy.p_slice_entropy, entropy.p_slice_entropy_plain,
                  cavlc_slice.p_entropy),
            "chroma": (entropy.chroma_setup, entropy.chroma_setup_plain,
                       cavlc_slice.chroma_entropy)}


def k10_counted() -> tuple:
    """K10's four wrappers, whose .launches count its launches by form."""
    return tuple(fn for _, _, fn in k10_functions().values())


def k10_launches(want: dict) -> dict:
    """{wrapper name: launches} of K10's wrappers; `want` by form, the
    slices (or chroma setups) of a run: one launch a slice, band or chroma
    setup, none of a form not named."""
    names = {form: fn.__name__ for form, (_, _, fn) in k10_functions().items()}
    return {names[f]: want.get(f, 0) for f in names}


def k10_levels(rng, shape) -> np.ndarray:
    """Seeded random zig-zag level lists (shape (..., L), int32) that reach
    every branch of the CAVLC block syntax, a kind drawn per list: none;
    sparse at a random density; every coefficient nonzero (16 of 16, 15 of
    15); all nonzero with three trailing +-1 (more than 10 nonzeros with
    TrailingOnes 3); magnitudes growing from the last coefficient to 2026
    (suffixLength up to 6 and its escape); two far apart (zerosLeft > 6);
    trailing ones alone. Amplitudes up to 3000 take both level escapes."""
    L = shape[-1]
    n = int(np.prod(shape[:-1]))
    kind = rng.integers(0, 7, (n, 1))
    amp = rng.choice([1, 2, 3, 9, 40, 300, 3000], (n, 1))
    sign = rng.choice([-1, 1], (n, L))
    val = sign * rng.integers(1, amp + 1, (n, L))
    dens = rng.uniform(0.05, 0.5, (n, 1))
    pos = np.arange(L)
    out = np.where(kind == 1, np.where(rng.random((n, L)) < dens, val, 0), 0)
    out = np.where(kind == 2, val, out)
    out = np.where(kind == 3, np.where(pos >= L - 3, sign, val), out)
    out = np.where(kind == 4, sign * (1 + 9 * (L - 1 - pos) ** 2), out)
    far = (pos == 0) | (pos == L - 1)
    out = np.where(kind == 5, np.where(far, val, 0), out)
    out = np.where(kind == 6, np.where(rng.random((n, L)) < 0.2, sign, 0), out)
    return out.reshape(shape).astype(np.int32)


def k10_random_args(form: str, wmb: int, hmb: int, rng, skip=None) -> tuple:
    """Seeded random numpy arguments of a K10 form's function for a grid
    of wmb x hmb MBs (k10_levels' lists; a quarter of the MBs with no luma
    AC and a third with no chroma AC or DC). P: skip (nmb,) bool (random
    when None; levels zero there), every mb_type 0-4, mvds small and up to
    +-2^15 - 1. Mixed: both classes, with CBP and the final TotalCoeffs as
    K6 derives them from the winner's levels."""
    nmb = wmb * hmb
    cdc, cac = k10_levels(rng, (2, nmb, 4)), k10_levels(rng, (2, nmb, 4, 15))
    cac[:, rng.random(nmb) < 0.3] = 0
    cdc[:, rng.random(nmb) < 0.3] = 0
    if form == "chroma":
        return cdc, cac
    modes = [rng.integers(0, 4, nmb).astype(np.int32) for _ in range(2)]
    if form == "p":
        skip = rng.random(nmb) < 0.4 if skip is None else skip
        mb_type = rng.integers(0, 5, nmb).astype(np.int32)
        mvd = np.where(rng.random((nmb, 4, 2)) < 0.8, rng.integers(-20, 21, (nmb, 4, 2)),
                       rng.choice([-32767, -8192, 8191, 32767], (nmb, 4, 2))).astype(np.int32)
        luma = k10_levels(rng, (nmb, 16, 16))
        luma[skip], cdc[:, skip], cac[:, skip] = 0, 0, 0
        return skip, mb_type, mvd, luma, cdc, cac
    i16dc, i16ac = k10_levels(rng, (nmb, 16)), k10_levels(rng, (nmb, 16, 15))
    i16ac[rng.random(nmb) < 0.25] = 0
    if form == "i16":
        return (*modes, i16dc, i16ac, cdc, cac)
    lv4 = k10_levels(rng, (nmb, 16, 16))
    lv4[rng.random(nmb) < 0.2] = 0
    choice4 = rng.random(nmb) < 0.5
    tc16, tc4 = (np.count_nonzero(lv, axis=-1) for lv in (i16ac, lv4))
    cbp16 = np.where(tc16.any(axis=1), 15, 0)
    dc_only = np.zeros_like(tc16)
    dc_only[:, 0] = np.count_nonzero(i16dc, axis=1)
    quads = tc4.reshape(nmb, 4, 4).any(axis=2)
    cbp4 = (quads << np.arange(4)).sum(axis=1)
    cbp_luma = np.where(choice4, cbp4, cbp16).astype(np.int32)
    tc_luma = np.where(choice4[:, None], tc4 * np.repeat(quads, 4, axis=1),
                       np.where(cbp16[:, None] == 15, tc16, dc_only)).astype(np.int32)
    return (choice4, *modes, i16dc, i16ac, lv4, rng.random((nmb, 16)) < 0.5,
            rng.integers(0, 8, (nmb, 16)).astype(np.int32), cbp_luma, tc_luma, cdc, cac)


def k10_err(torch, got: dict, want: dict) -> int:
    """Largest absolute difference over every key of the plain twin's dict
    (the words compared byte by byte, all of them); a key missing, or of
    another shape or dtype, fails."""
    if set(got) != set(want):
        raise AssertionError(f"K10 keys {sorted(got)} != plain {sorted(want)}")
    err = 0
    for key, w in want.items():
        g = got[key]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"K10 {key}: {g.dtype} {tuple(g.shape)} != plain "
                                 f"{w.dtype} {tuple(w.shape)}")
        if key == "words":
            g, w = g.contiguous().view(torch.uint8), w.contiguous().view(torch.uint8)
        err = max(err, max_err(torch, [g], [w]))
    return err


def k10_needed(form: str, args, kw) -> tuple:
    """(the arguments K10's function needs to read, its level arrays among
    them) for this run's data: every argument, but in the mixed form only
    the winner's luma levels of each MB (lv4 at an Intra4x4 MB, i16dc and
    i16ac at an Intra16x16 one) and the chroma levels the chroma setup's
    cbp_chroma codes (DC where it is 1 or 2, AC where it is 2)."""
    pos = K10_LEVELS[form]
    if form != "mixed":
        return list(args), [args[i] for i in pos]
    i4, cbp_c = args[0], kw["chroma"]["cbp_chroma"]
    i16dc, i16ac, lv4, cdc, cac = (args[i] for i in pos)
    levels = [i16dc[~i4], i16ac[~i4], lv4[i4], cdc[:, cbp_c > 0], cac[:, cbp_c == 2]]
    return [a for i, a in enumerate(args) if i not in pos] + levels, levels


def check_k10(torch, label: str, form: str, args, wmb: int, hmb: int, time_it=False, **kw):
    """K10 (form's dispatcher, on the card tensors args, with kw: top_ctx,
    valid, run_lead; mixed: chroma, the chroma setup's output) against its
    plain twin on the same inputs, every key. Returns (max_abs_err, ms,
    plain_ms, bound_ms, bound_by, queued_ms) (times None unless time_it;
    every timed call is held to the plain output too), the plain output and
    the queued ms of the call's workspace fill alone (None unless
    time_it)."""
    fn, plain, _ = k10_functions()[form]
    got = fn(*args, wmb, hmb, **kw)
    want, plain_ms = timed_once(torch, lambda: plain(*args, wmb, hmb, **kw))
    if form == "chroma":  # the plain chain's symbol streams stay inside it
        want = {k: want[k] for k in got}
    err = k10_err(torch, got, want)
    ms = queued_ms = fill_ms = None
    if time_it:
        from h264_fer_tpu_torch.kernels.cavlc_slice import fill

        def check(out):
            if k10_err(torch, out, want):
                raise AssertionError(f"K10 {form} {label}: a timed call != plain")
        ms, queued_ms = kernel_ms(torch, lambda: fn(*args, wmb, hmb, **kw), 20, check)
        fill_ms = cuda_ms(torch, lambda: fill(form, wmb * hmb, args[0].device), 20,
                          queued=True)
    # each input the function needs read once (the halo and the chroma
    # setup too), each state output written once, and the words the payload
    # uses; the operations on the levels it needs
    read, levels = k10_needed(form, args, kw)
    ins = [*read, *(kw.get("top_ctx") or ()),
           *(kw["chroma"][k] for k in ("cbp_chroma", "tc_chroma") if "chroma" in kw)]
    outs = [v for k, v in got.items() if k not in ("words", "nbits", "trail_bits")
            and not any(v is a for a in (*args, *ins))]
    used = 8 * ((int(got["nbits"]) + 63) // 64) if "nbits" in got else 0
    moved = nbytes(*ins, *outs) + used
    bound_ms, bound_by = bound(moved, cavlc_size_ops(*(lv.cpu().numpy() for lv in levels)))
    print(f"K10 {form} {label}: max_abs_err {err} (tolerance 0, every key, the words in "
          f"full), {int(got['nbits']) if 'nbits' in got else int(got['bits'].sum())} bits"
          + (f", kernel {ms:.4f} ms (queued {queued_ms:.4f}, of which the workspace fill "
             f"alone {fill_ms:.4f}), plain {plain_ms:.2f} ms" if time_it else "")
          + f", bound {bound_ms:.4f} ms ({bound_by}, {moved} bytes)", flush=True)
    if err != 0:
        raise AssertionError(f"K10 {form} {label}: kernel != plain")
    return (err, ms, plain_ms, bound_ms, bound_by, queued_ms), want, fill_ms


def k10_frame_args(torch, dev, frame, pair, qp) -> dict:
    """{form: (args, kw)} of K10 on a 1080p content frame at qp, made by
    the path's kernels: K1t's levels (i16); K7, the chroma setup and K6
    (mixed, with the setup as `chroma`, as the path passes it; chroma);
    K2-K5 and the P residual on the content pair (frame 1 from frame 0)."""
    from h264_fer_tpu_torch.codec.entropy import chroma_setup
    from h264_fer_tpu_torch.kernels.wavefront_i16 import chroma_frame, i16_frame
    from h264_fer_tpu_torch.kernels.wavefront_mixed import mixed_luma
    from h264_fer_tpu_torch.ops.transform import chroma_qp

    y, cb, cr, m16, cm = i16_inputs(torch, dev, frame, qp, None)
    _, i16dc, ac, _, _, cdc, cac = i16_frame(y, cb, cr, m16, cm, qp, chroma_qp(qp))
    out = {"i16": ((m16, cm, i16dc, ac, cdc, cac), {})}
    dec, cm, (cdc, cac), args = mixed_inputs(torch, (y, cb, cr), qp, chroma_frame)
    mx = mixed_luma(*args)
    ch = chroma_setup(cdc, cac, W // 16, H // 16)
    out["mixed"] = ((mx["choice4"], dec["mode16"], cm, *(mx[k] for k in (
        "i16dc", "i16ac", "lv4", "prev_flags", "rem_modes", "cbp_luma", "tc_luma")),
        cdc, cac), {"chroma": ch})
    out["chroma"] = ((cdc, cac), {})
    zero = torch.zeros(((W // 16) * (H // 16), 4, 2), dtype=torch.int32, device=dev)
    out["p"] = (p_frame_stages(torch, p_kernels(plain=False), pair[1], (*pair[0], zero),
                               qp)[1]["entropy"], {})
    return out


def k10_band(torch, form, args, kw, want, wmb, r0, hl):
    """The arguments of MB rows [r0, r0 + hl) of a frame's K10 inputs
    `args` as a band: its rows, top_ctx the frame's state one MB row above
    (the plain output `want`), valid False on the band's last MB row (an
    uneven band's padded MBs; I16 and mixed), a P band's run_lead the skips
    before it as a tensor on the card."""
    nmb = args[0].shape[1] if form == "chroma" else args[0].shape[0]
    mbs = slice(wmb * r0, wmb * (r0 + hl))
    cut = [a[:, mbs] if a.dim() >= 3 and a.shape[0] == 2 and a.shape[1] == nmb else a[mbs]
           for a in args]
    row = slice(wmb * (r0 - 1), wmb * r0)
    ctx = (want["tc_luma"][row], want["cbp_luma"][row], want["tc_chroma"][:, row],
           want["cbp_chroma"][row]) if form != "chroma" else (want["tc_chroma"][:, row],
                                                              want["cbp_chroma"][row])
    band_kw = {"top_ctx": ctx}
    if form in ("i16", "mixed"):
        band_kw["valid"] = torch.arange(wmb * hl, device=args[0].device) < wmb * (hl - 1)
    if form == "p":
        idx = torch.arange(wmb * r0, device=args[0].device)
        last = torch.where(args[0][: wmb * r0], -1, idx).amax()
        band_kw["run_lead"] = wmb * r0 - last - 1  # a 0-d tensor on the card
    if form == "mixed":
        from h264_fer_tpu_torch.codec.entropy import chroma_setup

        cdc, cac = cut[-2:]
        band_kw["chroma"] = chroma_setup(cdc, cac, wmb, hl, ctx[2:])
    return cut, band_kw


def k10_skipped_blocks(torch, args, wmb: int, hmb: int):
    """A P frame's K10 arguments (skip, mb_type, mvd, luma, cdc, cac) with
    whole tickets of MBs skipped (levels zeroed there): every other ticket
    of the first MB rows, then a run of more than 32 tickets (one look-back
    window) with no coded MB, then every third ticket; so that the
    look-back carries the last coded MB across tickets and windows that
    have none."""
    from h264_fer_tpu_torch.kernels.cavlc_slice import MBS_PER_TICKET, tickets

    nmb = wmb * hmb
    t = torch.arange(nmb, device=args[0].device) // MBS_PER_TICKET
    nt = tickets(nmb)
    skip = args[0] | (t % 2 == 1) & (t < nt // 4)
    skip |= (t >= nt // 4) & (t < nt // 4 + 40)
    skip |= (t >= nt // 2) & (t % 3 != 0)
    luma, cdc, cac = (a.clone() for a in args[3:])
    luma[skip], cdc[:, skip], cac[:, skip] = 0, 0, 0
    return (skip, args[1], args[2], luma, cdc, cac)


def k10_phase(torch, dev, name) -> tuple:
    """Phase 13: K10 against its plain twins, bit-exact on every key, at
    1080p (QP 8, 28, 46 on a content frame's levels and decisions, each
    form, timed at QP 28; the band forms on band 1 of 4 at QP 28; the QP 28
    P frame with whole tickets skipped, as a slice and as a band), and on
    the small grids with k10_random_args' inputs, as whole slices and as
    bands. Returns ({form: (max_abs_err over every check, ms, plain_ms,
    bound_ms, bound_by, queued_ms) at 1080p QP 28}, {form: the queued ms of
    its workspace fill alone})."""
    frame = content(1, W, H)[0]
    pair = [tuple(torch.from_numpy(p).to(dev) for p in f) for f in content(2, W, H)]
    errs, timed, fills = dict.fromkeys(K10_ROWS, 0), {}, {}
    wmb, hl = W // 16, H // 16 // BAND_TILES
    for qp in CHECK_QPS:
        for form, (args, kw) in k10_frame_args(torch, dev, frame, pair, qp).items():
            res, want, fill = check_k10(torch, f"{W}x{H} qp{qp}", form, args, wmb, H // 16,
                                        time_it=qp == QP, **kw)
            errs[form] = max(errs[form], res[0])
            if qp != QP:
                continue
            timed[form], fills[form] = res, fill
            cut, band_kw = k10_band(torch, form, args, kw, want, wmb, hl, hl)
            res, _, _ = check_k10(torch, f"{W}x{H} qp{qp} band 1 of {BAND_TILES} (real "
                                  "top_ctx, padded last row, run_lead on the card)", form,
                                  cut, wmb, hl, **band_kw)
            errs[form] = max(errs[form], res[0])
            if form == "p":
                args = k10_skipped_blocks(torch, args, wmb, H // 16)
                res, want, _ = check_k10(torch, f"{W}x{H} qp{qp} whole tickets skipped",
                                         form, args, wmb, H // 16)
                errs[form] = max(errs[form], res[0])
                cut, band_kw = k10_band(torch, form, args, kw, want, wmb, hl, hl)
                res, _, _ = check_k10(torch, f"{W}x{H} qp{qp} whole tickets skipped, band 1 "
                                      f"of {BAND_TILES}", form, cut, wmb, hl, **band_kw)
                errs[form] = max(errs[form], res[0])
    rng = np.random.default_rng(SEED + 10)
    for label, w, h in K10_QCIF_GRIDS:
        gw, gh = w // 16, h // 16
        nmb = gw * gh
        for form in K10_ROWS:
            args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for a in k10_random_args(form, gw, gh, rng))
            kw = {}
            if form == "mixed":
                from h264_fer_tpu_torch.codec.entropy import chroma_setup

                kw["chroma"] = chroma_setup(*args[-2:], gw, gh)
            res, want, _ = check_k10(torch, f"{label} random", form, args, gw, gh, **kw)
            errs[form] = max(errs[form], res[0])
            if gh > 2:  # MB rows [1, gh - 1) as a band
                cut, band_kw = k10_band(torch, form, args, kw, want, gw, 1, gh - 2)
                res, _, _ = check_k10(torch, f"{label} random band", form, cut, gw, gh - 2,
                                      **band_kw)
                errs[form] = max(errs[form], res[0])
        # P frames all skipped, with the last MB and with the first MB skipped
        for case, skip in (("all skipped", np.ones(nmb, bool)),
                           ("last MB skipped", np.arange(nmb) >= nmb - 1),
                           ("first MB skipped", np.arange(nmb) == 0),
                           ("only the first MB coded", np.arange(nmb) > 0)):
            args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for a in k10_random_args("p", gw, gh, rng, skip=skip))
            for run_lead in (None, 3, torch.tensor(7, device=dev)):
                res, _, _ = check_k10(torch, f"{label} {case}, run_lead {run_lead}", "p",
                                      args, gw, gh, run_lead=run_lead)
                errs["p"] = max(errs["p"], res[0])
    print(f"K10 checks done: max_abs_err {errs} on {name}", flush=True)
    return {form: (errs[form], *timed[form][1:]) for form in K10_ROWS}, fills


# K11, the intra mode decision: its forms, the XLA program both replace
# (tpu_intra.intra_mode_decision_impl with modes_only=True; i16_only=True
# for the I16 form) and their rows in the kernels line
K11_ROWS = {"i16": ("mode_decision_i16", "h264_fer_tpu/codec/tpu_intra.py:55"),
            "full": ("mode_decision_full", "h264_fer_tpu/codec/tpu_intra.py:55")}
K11_GRIDS = (("16x16", 16, 16), ("176x144", 176, 144), ("80x176", 80, 176),
             ("16x144", 16, 144), ("176x16", 176, 16))


def k11_functions():
    """{form: (K11 dispatcher, plain twin, wrapper whose .launches count it)}."""
    from h264_fer_tpu_torch.codec import intra_decision
    from h264_fer_tpu_torch.kernels import mode_decision

    return {"i16": (intra_decision.intra16_mode_decision,
                    intra_decision.intra16_mode_decision_plain, mode_decision.i16_decision),
            "full": (intra_decision.intra_mode_decision,
                     intra_decision.intra_mode_decision_plain, mode_decision.full_decision)}


def k11_counted() -> tuple:
    """K11's two wrappers, whose .launches count its launches by form."""
    return tuple(fn for _, _, fn in k11_functions().values())


def k11_launches(want: dict) -> dict:
    """{wrapper name: launches} of K11's wrappers; `want` by form, the
    decisions of a run (one launch a frame or band), none of a form not
    named."""
    names = {form: fn.__name__ for form, (_, _, fn) in k11_functions().items()}
    return {names[f]: want.get(f, 0) for f in names}


def k11_ops(qp: int, nmb: int, full: bool) -> float:
    """int32 operations of K11's function on nmb MBs. Per 4x4-block
    candidate and sample: the residual, h = d ? 64 d - 32 : 0, the forward
    core transform (k1_pixel_ops' count), the quantisation and the |.| sum;
    the prediction: Intra16x16 V and H copy, DC and Plane from the MB's
    parameters (36 and 54 a MB), a Plane sample ~5; Intra4x4 V and H copy, a
    directional sample ~5, DC 10 a block; the gates and first-min scans (2
    a mode), the sums of the 16 blocks."""
    sample = 1 + 3 + 2 * 22 / 4 + (5 if qp < 24 else 4) + 2
    i16 = nmb * (4 * 256 * sample + 256 * 5 + 36 + 54 + 4 * (16 + 2))
    if not full:
        return i16
    return i16 + nmb * 16 * (9 * 16 * sample + 6 * 16 * 5 + 10 + 9 * 2 + 1)


def k11_outputs(out) -> list:
    """The outputs of either form as a list (the full form's in its keys'
    order)."""
    return list(out.values()) if isinstance(out, dict) else list(out)


def check_k11(torch, label: str, y, qp: int, top_row=None, time_it=False) -> dict:
    """K11's two forms (the dispatchers, on the uint8 card plane y and on y
    as int32, with top_row) against their plain twins on the card,
    bit-exact on every output. Returns {form: (max_abs_err, ms, plain_ms,
    bound_ms, bound_by, queued_ms)} (times None unless time_it, taken on the
    uint8 plane as the paths pass it; every timed call is held to the plain
    output too)."""
    out = {}
    for form, (fn, plain, _) in k11_functions().items():
        want, plain_ms = timed_once(torch, lambda: k11_outputs(plain(y, qp, top_row)))
        err = max(max_err(torch, k11_outputs(fn(plane, qp, top_row)), want)
                  for plane in (y, y.to(torch.int32)))
        ms = queued_ms = None
        if time_it:
            ms, queued_ms = kernel_ms(torch, lambda: k11_outputs(fn(y, qp, top_row)), 20,
                                      same_as(torch, want, f"K11 {form} {label}"))
            plain_ms = cuda_ms(torch, lambda: plain(y, qp, top_row), 3)
        # the plane and the row above read once, every output written once
        moved = nbytes(y, *want) + (0 if top_row is None else nbytes(top_row))
        bound_ms, bound_by = bound(moved, k11_ops(qp, y.numel() // 256, form == "full"))
        print(f"K11 {form} {label} qp{qp}: max_abs_err {err} (tolerance 0, every output, "
              "uint8 and int32 planes)"
              + (f", kernel {ms:.4f} ms (queued {queued_ms:.4f}), plain {plain_ms:.2f} ms"
                 if time_it else "")
              + f", bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        if err != 0:
            raise AssertionError(f"K11 {form} {label} qp{qp}: kernel != plain")
        out[form] = (err, ms, plain_ms, bound_ms, bound_by, queued_ms)
    return out


def k11_phase(torch, dev, name) -> dict:
    """Phase 14: K11's two forms against their plain twins, bit-exact on
    every output (check_k11), on 1080p content at QP 8, 28 and 46 (timed at
    QP 28), band 1 of 4 with the source row above as top_row and with that
    row holding -1 entries, seeded uniform-random frames, flat frames of 0,
    128 and 255 (every mode ties: the gates and the first-min order
    decide), stripe frames, and the K11_GRIDS. Returns {form: (max_abs_err
    over every check, ms, plain_ms, bound_ms, bound_by, queued_ms) at 1080p
    QP 28}."""
    t0 = time.perf_counter()
    errs, timed = dict.fromkeys(K11_ROWS, 0), {}

    def run(label, y, qp, top_row=None, time_it=False):
        res = check_k11(torch, label, y, qp, top_row, time_it)
        for form in K11_ROWS:
            errs[form] = max(errs[form], res[form][0])
        return res

    def card_plane(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8)).to(dev)

    rng = np.random.default_rng(SEED + 11)
    y = card_plane(content(1, W, H)[0][0])
    for qp in CHECK_QPS:
        res = run(f"{W}x{H} content", y, qp, time_it=qp == QP)
        if qp == QP:
            timed = res
    hl = H // 16 // BAND_TILES  # band 1: MB rows [hl, 2 hl), the source row above it
    band, top = y[16 * hl: 32 * hl], y[16 * hl - 1].to(torch.int32)
    holes = top.clone()
    holes[torch.from_numpy(rng.random(W) < 0.3).to(dev)] = -1
    holes[:16] = -1
    for qp in CHECK_QPS:
        run(f"{W}x{H} band 1 of {BAND_TILES}, real top_row", band, qp, top)
    run(f"{W}x{H} band 1 of {BAND_TILES}, top_row with -1 entries", band, QP, holes)
    for qp in CHECK_QPS:
        run(f"{W}x{H} uniform random", card_plane(rng.integers(0, 256, (H, W))), qp)
    for v in (0, 128, 255):
        run(f"{W}x{H} flat {v}", torch.full((H, W), v, dtype=torch.uint8, device=dev), QP)
    yy, xx = np.mgrid[0:H, 0:W]
    run(f"{W}x{H} vertical stripes", card_plane(xx // 3 % 2 * 255), QP)
    run(f"{W}x{H} horizontal stripes", card_plane(yy // 5 % 2 * 200 + 20), 8)
    for label, w, h in K11_GRIDS:
        run(f"{label} content", card_plane(content(1, w, h)[0][0]), QP)
        for qp in (0, 51):
            run(f"{label} uniform random", card_plane(rng.integers(0, 256, (h, w))), qp)
        run(f"{label} flat 255", torch.full((h, w), 255, dtype=torch.uint8, device=dev), QP)
    print(f"K11 checks done: max_abs_err {errs} ({time.perf_counter() - t0:.1f} s) on {name}",
          flush=True)
    return {form: (errs[form], *timed[form][1:]) for form in K11_ROWS}


def main() -> int:
    import faulthandler

    import torch

    faulthandler.enable()  # a crash in native code prints each thread's Python stack

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from h264_fer_tpu_torch.kernels.interp import interp_planes
    from h264_fer_tpu_torch.kernels.mc import mc_bulk
    from h264_fer_tpu_torch.kernels.me_int import integer_score_map
    from h264_fer_tpu_torch.kernels.me_qpel import qpel_refine_maps
    from h264_fer_tpu_torch.kernels.residual_p import residual_recon
    from h264_fer_tpu_torch.kernels import wavefront_i16
    from h264_fer_tpu_torch.kernels.deblock import deblock_frame
    from h264_fer_tpu_torch.kernels.wavefront_i16 import chroma_frame, i16_frame, i16_recon
    from h264_fer_tpu_torch.kernels.wavefront_mixed import mixed_luma
    from h264_fer_tpu_torch.kernels.wavefront_p import pframe_decide
    from h264_fer_tpu_torch.ops.transform import chroma_qp
    from h264_fer_tpu_torch.parallel.gop_device import GopIntraEncoder, GopIpppEncoder

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = card()
    print(f"card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # ---- 1. build ------------------------------------------------------------
    build_all()

    print(f"[phase 1 done at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- 2. K1 and K1t kernels vs plain ------------------------------------
    rng = np.random.default_rng(SEED)  # phase 6 draws on after phase 2
    k1, k1t, k1_launches = k1_phase(torch, dev, rng)
    print(f"K1 and K1t checks done on {name}", flush=True)

    print(f"[phase 2 done at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- 3. main path ----------------------------------------------------------
    frames = content(N_FRAMES, W, H)
    enc = GopIntraEncoder(W, H, QP, device=dev)
    enc.encode_sequence(frames[:2])  # warm-up: allocator, library load, program capture
    torch.cuda.synchronize()
    k10, k11 = k10_counted(), k11_counted()
    for fn in (i16_recon, i16_frame, *k10, *k11):
        fn.launches = 0
    t0 = time.perf_counter()
    stream = enc.encode_sequence(frames)
    e2e_s = [time.perf_counter() - t0]
    launches = i16_frame.launches  # counted by the kernel's C entry point
    if (launches, i16_recon.launches) != (N_FRAMES, 0):
        raise AssertionError(f"K1t launched {launches} times, K1 {i16_recon.launches}, "
                             f"expected {N_FRAMES} and 0")
    k10_path = {"i16": {fn.__name__: fn.launches for fn in k10}}
    if k10_path["i16"] != k10_launches({"i16": N_FRAMES}):
        raise AssertionError(f"all-intra K10 launches {k10_path['i16']}")
    k11_path = {"i16": {fn.__name__: fn.launches for fn in k11}}
    if k11_path["i16"] != k11_launches({"i16": N_FRAMES}):
        raise AssertionError(f"all-intra K11 launches {k11_path['i16']}")
    if k1_launches != 1:
        raise AssertionError(f"K1 launched {k1_launches} times in one call")
    plain, plain_recon = plain_chain(torch, dev, enc, frames)
    if stream != plain:
        raise AssertionError("kernel-path stream != plain-chain stream")
    parse_stream(stream, N_FRAMES, W, H, QP)
    check_bytes("all-intra", stream)
    # the decode gate (phase 15): the plain chain's recon of every frame
    to_decode = {"all-intra": (stream, plain_recon, {})}
    qcif = qcif_clip(10)
    check_device_qcif("all-intra", *(GopIntraEncoder(176, 144, QP, device=d).encode_sequence(
        qcif) for d in (dev, "cpu")))
    for _ in range(E2E_REPS - 1):
        t0 = time.perf_counter()
        enc.encode_sequence(frames)
        e2e_s.append(time.perf_counter() - t0)
    fps = sorted(N_FRAMES / t for t in e2e_s)
    print(f"main path: {N_FRAMES} frames {W}x{H} QP{QP}, {len(stream)} bytes, "
          f"== plain chain, parses; K10 launches {k10_path['i16']}, K11 {k11_path['i16']}; "
          "QCIF == CPU == its "
          f"JAX digest; e2e fps median {fps[len(fps) // 2]:.2f} "
          f"(runs {', '.join(f'{v:.2f}' for v in fps)}) on {name}", flush=True)

    from h264_fer_tpu_torch.codec.iframe import device_i16_frame

    dframes = [tuple(torch.from_numpy(p).to(dev) for p in f) for f in frames]
    qpc = chroma_qp(QP)

    def all_frames():
        for f in dframes:
            device_i16_frame(*f, QP, qpc)

    frame_ms = sorted(cuda_ms(torch, all_frames, 1) / N_FRAMES for _ in range(3))
    print(f"device frame: median {frame_ms[1]:.2f} ms "
          f"({1e3 / frame_ms[1]:.2f} fps; runs "
          f"{', '.join(f'{v:.2f}' for v in frame_ms)} ms) on {name}", flush=True)
    stages = stage_times(torch, dev, frames[0])
    print("stages (device ms, one frame): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f" on {name}", flush=True)
    wall, busy, replays = replay_busy(torch, lambda: enc.encode_sequence(frames[:2]))
    print(f"timed 2-frame encode: wall {wall:.1f} ms, {replays} program replays "
          f"{busy:.1f} ms on the device (CUDA events), device busy "
          f"{100 * busy / wall:.1f} % on {name}", flush=True)
    print(capture_line("all-intra", enc.lanes[0].programs, name), flush=True)
    print(eager_beside(torch, "all-intra", lambda: GopIntraEncoder(W, H, QP, device=dev),
                       frames, name, 2), flush=True)

    print(f"[phase 3 done at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- 4. K2-K5 kernels vs plain twins ------------------------------------
    check_p_small_grids(torch, dev)
    k2_err = check_k2_shapes(torch, dev)
    pair = [tuple(torch.from_numpy(p).to(dev) for p in f) for f in content(3, W, H)]
    zero_mv = torch.zeros(((W // 16) * (H // 16), 4, 2), dtype=torch.int32, device=dev)
    pk = {}
    for qp in P_QPS:
        # two frames in a chain: frame 1 from frame 0 with no previous MVs,
        # then frame 2 from frame 1 with frame 1's MVs as the c2 centres
        _, dec = check_p_kernels(torch, f"{W}x{H}", pair[0], pair[1], zero_mv, qp)
        pk[qp], _ = check_p_kernels(torch, f"{W}x{H} chained", pair[1], pair[2],
                                    dec["mv"], qp, time_it=qp == QP)
    k1213 = check_k12_k13(torch, dev)
    print(f"K13, K2-K5 and K12 checks done on {name}", flush=True)

    print(f"[phase 4 done at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- 5. IPPP main path -----------------------------------------------------
    frames = content(N_IPPP, W, H)
    enc = GopIpppEncoder(W, H, QP, gop_len=GOP_LEN, device=dev)
    # warm-up: allocator, library loads, the GOP program's capture
    enc.encode_sequence(frames[:GOP_LEN])
    torch.cuda.synchronize()
    counted = (i16_frame, interp_planes, integer_score_map, qpel_refine_maps, pframe_decide,
               mc_bulk, residual_recon, *k10, *k11)
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    stream = enc.encode_sequence(frames, keep_recon=True)  # each frame's reference planes
    e2e_s = [time.perf_counter() - t0]
    recon = enc.recon
    p_launches = {fn.__name__: fn.launches for fn in counted}
    # its P frames' chroma decodes right in the spec-correct mode only
    to_decode["IPPP"] = (stream, recon, {"spec_mode": True})
    n_gops, n_p = N_IPPP // GOP_LEN, N_IPPP - N_IPPP // GOP_LEN
    want = {"i16_frame": n_gops, "interp_planes": n_p, "integer_score_map": n_p,
            "qpel_refine_maps": n_p, "pframe_decide": n_p, "mc_bulk": n_p,
            "residual_recon": n_p,
            **k10_launches({"i16": n_gops, "p": n_p}), **k11_launches({"i16": n_gops})}
    if p_launches != want:
        raise AssertionError(f"IPPP launches {p_launches}, expected {want}")
    lens = [GOP_LEN] * n_gops
    plain = plain_ippp_stream(torch, dev, enc, frames[:N_PLAIN_IPPP])
    rest = stream[len(plain):]  # the first GOP goes on with a P slice
    if not stream.startswith(plain) or not rest.startswith(b"\x00\x00\x00\x01\x21"):
        raise AssertionError("IPPP first frames != plain-chain stream")
    parse_ippp_stream(stream, lens, W, H, QP)
    check_bytes("IPPP", stream)
    qcif = qcif_clip(6)
    check_device_qcif("IPPP", *(GopIpppEncoder(176, 144, QP, gop_len=4, device=d)
                                .encode_sequence(qcif) for d in (dev, "cpu")))
    for _ in range(E2E_REPS - 1):
        t0 = time.perf_counter()
        enc.encode_sequence(frames)
        e2e_s.append(time.perf_counter() - t0)
    fps = sorted(N_IPPP / t for t in e2e_s)
    print(f"IPPP main path: {N_IPPP} frames {W}x{H} QP{QP} GOP {GOP_LEN}, "
          f"{len(stream)} bytes, first {N_PLAIN_IPPP} frames == plain chain, parses, "
          "QCIF == CPU == its JAX digest; launches "
          f"{p_launches}; e2e fps median {fps[len(fps) // 2]:.2f} "
          f"(runs {', '.join(f'{v:.2f}' for v in fps)}) on {name}", flush=True)
    stages = p_stage_times(torch, dev, frames)
    print("P stages (device ms, one frame): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f", sum {sum(stages.values()):.3f} on {name}", flush=True)
    wall, busy, replays = replay_busy(torch, lambda: enc.encode_sequence(frames[:GOP_LEN]))
    print(f"timed {GOP_LEN}-frame IPPP GOP: wall {wall:.1f} ms, {replays} program replays "
          f"{busy:.1f} ms on the device (CUDA events), device busy "
          f"{100 * busy / wall:.1f} % on {name}", flush=True)
    print(capture_line("IPPP", enc.lanes[0].programs, name), flush=True)
    print(eager_beside(torch, "IPPP", lambda: GopIpppEncoder(W, H, QP, gop_len=GOP_LEN,
                                                            device=dev),
                       frames, name, GOP_LEN), flush=True)

    print(f"[phase 5 done at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- 6. K4x4, K7 and K6 kernels vs plain twins ----------------------------
    # random Intra4x4 modes in every block; the three grids forced to 1 and
    # 3 blocks on QCIF, 16x176 and 176x16 (and on 64x208 below)
    for label, w, h in SMALL + [("16x176", 16, 176), ("176x16", 176, 16)]:
        f = tuple(torch.from_numpy(p).to(dev) for p in content(1, w, h)[0])
        m4 = torch.from_numpy(rng.integers(0, 9, ((w // 16) * (h // 16), 16))
                              .astype(np.int32)).to(dev)
        check_mixed_kernels(torch, f"{label} random modes", f, 30, mode4=m4,
                            blocks=(1, 3) if (w, h) != (80, 176) else ())
    _, n4, _, _ = check_mixed_kernels(torch, "64x208", tuple(
        torch.from_numpy(p).to(dev) for p in tall_frame()), 30, blocks=(1, 3))
    if not 0 < n4 < 52:
        raise AssertionError(f"64x208: {n4} I4x4 MBs; both classes should win")
    frames = content(N_FRAMES, W, H)  # the mixed path's frames
    frame = tuple(torch.from_numpy(p).to(dev) for p in frames[0])
    mk = {}
    for qp in CHECK_QPS:
        mk[qp], n4, launched, payload = check_mixed_kernels(
            torch, f"{W}x{H}", frame, qp, time_it=qp == QP)
        if qp == QP:  # the plain chain of the mixed path's first frame
            k4_launches, plain_payload = launched, payload
            if not 0 < n4 < (W // 16) * (H // 16):
                raise AssertionError(f"K6 chose I4x4 at {n4} MBs: the arbitration "
                                     f"should run both ways at QP {QP}")
    if k4_launches != 1:
        raise AssertionError(f"K4x4 launched {k4_launches} times in one call, expected 1")
    print(f"K4x4, K7 and K6 checks done on {name}", flush=True)

    print(f"[phase 6 done at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- 7. mixed all-intra path ------------------------------------------------
    enc = GopIntraEncoder(W, H, QP, mode="mixed", device=dev)
    # warm-up: allocator, library loads, the frame program's capture (the
    # only calls of the frame function's Python: a replay runs none)
    with mock.patch.object(wavefront_i16, "chroma_levels_from_recon",
                           wraps=wavefront_i16.chroma_levels_from_recon) as rebuilt:
        enc.encode_sequence(frames[:2])
    torch.cuda.synchronize()
    if rebuilt.call_count:
        raise AssertionError("the mixed path rebuilt the chroma levels from the recon")
    counted = (mixed_luma, chroma_frame, i16_recon, i16_frame, *k10, *k11)
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    stream = enc.encode_sequence(frames, keep_recon=True)
    e2e_s = [time.perf_counter() - t0]
    to_decode["mixed"] = (stream, enc.recon, {"spec_mode": True})
    m_launches = {fn.__name__: fn.launches for fn in counted}
    want = {"mixed_luma": N_FRAMES, "chroma_frame": N_FRAMES,
            "i16_recon": 0, "i16_frame": 0,
            **k10_launches({"chroma": N_FRAMES, "mixed": N_FRAMES}),
            **k11_launches({"full": N_FRAMES})}
    if m_launches != want:
        raise AssertionError(f"mixed launches {m_launches}, expected {want}")
    plain = enc.stitch([plain_payload])
    rest = stream[len(plain):]
    if not stream.startswith(plain) or not rest.startswith(b"\x00\x00\x00\x01\x25"):
        raise AssertionError("mixed first frame != plain-chain stream")
    parse_stream(stream, N_FRAMES, W, H, QP)
    check_bytes("mixed", stream)
    qcif = qcif_clip(2)
    check_device_qcif("mixed", *(GopIntraEncoder(176, 144, QP, mode="mixed", device=d)
                                 .encode_sequence(qcif) for d in (dev, "cpu")))
    for _ in range(E2E_REPS - 1):
        t0 = time.perf_counter()
        enc.encode_sequence(frames)
        e2e_s.append(time.perf_counter() - t0)
    fps = sorted(N_FRAMES / t for t in e2e_s)
    print(f"mixed path: {N_FRAMES} frames {W}x{H} QP{QP}, {len(stream)} bytes, "
          f"first frame == plain chain, parses, QCIF == CPU == its JAX digest; launches "
          f"{m_launches}; e2e fps "
          f"median {fps[len(fps) // 2]:.2f} (runs {', '.join(f'{v:.2f}' for v in fps)}) "
          f"on {name}", flush=True)
    stages = mixed_stage_times(torch, dev, frames[0])
    print("mixed stages (device ms, one frame): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f", sum {sum(stages.values()):.3f} on {name}", flush=True)
    wall, busy, replays = replay_busy(torch, lambda: enc.encode_sequence(frames[:2]))
    print(f"timed 2-frame mixed encode: wall {wall:.1f} ms, {replays} program replays "
          f"{busy:.1f} ms on the device (CUDA events), device busy "
          f"{100 * busy / wall:.1f} % on {name}", flush=True)
    print(capture_line("mixed", enc.lanes[0].programs, name), flush=True)
    print(eager_beside(torch, "mixed", lambda: GopIntraEncoder(W, H, QP, mode="mixed",
                                                              device=dev),
                       frames, name, 2), flush=True)

    print(f"[phase 7 done at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- 8. K8 kernel vs plain twin ----------------------------------------
    from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig

    frames = content(2, W, H)
    k8 = {}
    for qp in sorted(set(K8_I_QPS) | set(K8_P_QPS)):
        enc = Encoder(W, H, EncoderConfig(qp=qp), device=dev)
        enc.encode_frame(*frames[0])
        if qp in K8_I_QPS:
            k8["I", qp], _ = check_k8(torch, f"{W}x{H} I state",
                                      encoder_state(enc), qp)
        enc.encode_frame(*frames[1])
        if qp in K8_P_QPS:
            k8["P", qp], changed = check_k8(torch, f"{W}x{H} P state",
                                            encoder_state(enc), qp,
                                            time_it=qp == QP)
            if qp == QP and not changed:
                raise AssertionError(f"K8 filtered no sample of the P frame at QP {QP}")
    for label, w, h, qp in (("176x144 random state", 176, 144, 30),
                            ("64x208 random state", 64, 208, 38),
                            ("16x144 random state", 16, 144, 34),
                            ("176x16 random state", 176, 16, 34)):
        state = random_state(torch, dev, w, h, w + qp)
        k8[label, qp], _ = check_k8(torch, label, state, qp)
        if h > 16 and w > 16:  # the persistent grid forced small
            for blocks in (1, 3):
                k8[label, qp, blocks], _ = check_k8(torch, label, state, qp, blocks=blocks)
    print(f"K8 checks done on {name}", flush=True)

    print(f"[phase 8 done at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- 9. session path ---------------------------------------------------
    cfg = EncoderConfig(qp=QP, intra_every=SESSION_INTRA_EVERY, deblock=True)
    frames = content(N_SESSION, W, H)
    # warm-up: one IDR period, which captures the IDR and the P frame
    # programs; the session goes on with an IDR, so the stream below is a
    # fresh encoder's, frame for frame
    enc = Encoder(W, H, cfg, device=dev)
    enc.encode_sequence(frames[:SESSION_INTRA_EVERY])
    torch.cuda.synchronize()
    counted = (i16_frame, i16_recon, deblock_frame, interp_planes, integer_score_map,
               qpel_refine_maps, pframe_decide, mc_bulk, residual_recon, *k10, *k11)
    for fn in counted:
        fn.launches = 0
    recon = []
    t0 = time.perf_counter()
    stream = enc.headers()  # encode_sequence, keeping each frame's reference planes
    for f in frames:
        stream += enc.encode_frame(*f)
        recon.append(tuple(p.clone() for p in enc._ref))  # the programs' state: copied
    e2e_s = [time.perf_counter() - t0]
    s_launches = {fn.__name__: fn.launches for fn in counted}
    to_decode["session"] = (stream, recon, {"deblock": True})
    stats = enc.stats[-N_SESSION:]
    n_idr = sum(st["idr"] for st in stats)
    n_p = N_SESSION - n_idr
    want = {"i16_frame": n_idr, "i16_recon": 0, "deblock_frame": N_SESSION,
            "interp_planes": n_p, "integer_score_map": n_p, "qpel_refine_maps": n_p,
            "pframe_decide": n_p, "mc_bulk": n_p, "residual_recon": n_p,
            **k10_launches({"i16": n_idr, "p": n_p}),
            **k11_launches({"i16": n_idr})}
    if s_launches != want or n_idr != N_SESSION // SESSION_INTRA_EVERY:
        raise AssertionError(f"session launches {s_launches} with {n_idr} IDRs, "
                             f"expected {want}")
    plain = plain_session_stream(torch, dev, cfg, frames[:N_PLAIN_SESSION], counted)
    rest = stream[len(plain):]  # frame N_PLAIN_SESSION is a P slice
    if not stream.startswith(plain) or not rest.startswith(b"\x00\x00\x00\x01\x21"):
        raise AssertionError("session first frames != plain-chain stream")
    parse_session_stream(stream, stats, W, H, QP)
    if stream != Encoder(W, H, cfg, device=dev).encode_sequence(frames):
        raise AssertionError("session stream of a fresh encoder != the warmed encoder's")
    check_bytes("session", stream)
    qcif_sessions = []
    for iframe, qcif, qcfg in (
            ("i16", qcif_clip(10), EncoderConfig(qp=30, intra_every=4, deblock=True)),
            ("mixed", content(3, 176, 144), EncoderConfig(qp=QP, intra_every=2, deblock=True))):
        on_card, on_cpu = (Encoder(176, 144, qcfg, iframe=iframe, device=d).encode_sequence(qcif)
                           for d in (dev, "cpu"))
        if iframe == "i16":
            check_device_qcif("session", on_card, on_cpu)
        elif on_card != on_cpu:
            raise AssertionError(f"QCIF {iframe} session stream on the card != CPU path stream")
        qcif_sessions.append(on_card)
    for _ in range(E2E_REPS - 1):  # the session goes on: an IDR every 8 frames
        t0 = time.perf_counter()
        enc.encode_sequence(frames)
        e2e_s.append(time.perf_counter() - t0)
    fps = sorted(N_SESSION / t for t in e2e_s)
    print(f"session path: {N_SESSION} frames {W}x{H} QP{QP} intra_every "
          f"{SESSION_INTRA_EVERY} deblock, {n_idr} IDR + {n_p} P, {len(stream)} bytes, "
          f"first {N_PLAIN_SESSION} frames == plain chain, parses; launches {s_launches} "
          f"({s_launches['deblock_frame'] / N_SESSION:g} K8 per frame); e2e fps median "
          f"{fps[len(fps) // 2]:.2f} (runs {', '.join(f'{v:.2f}' for v in fps)}) on {name}",
          flush=True)
    # one replay of each program: the session stands at an IDR
    _, idr_ms = timed_once(torch, lambda: enc.encode_frame(*frames[0]))
    _, p_ms = timed_once(torch, lambda: enc.encode_frame(*frames[1]))
    i_state = Encoder(W, H, EncoderConfig(qp=QP), device=dev)
    i_state.encode_frame(*frames[0])
    i_state = encoder_state(i_state)
    k8_i_ms = cuda_ms(torch, lambda: deblock_frame(*i_state, QP, chroma_qp(QP)), 20)
    print(f"session stages (device ms, one frame): idr_frame {idr_ms:.3f}, p_frame "
          f"{p_ms:.3f}, k8_i_state {k8_i_ms:.4f}, k8_p_state {k8['P', QP][1]:.4f} "
          f"on {name}", flush=True)
    # replay_busy runs its call twice and times the second: 4 P frames,
    # then an IDR and 3 P frames (the content in order: no scene cut)
    enc.encode_sequence(frames[2:4])
    wall, busy, replays = replay_busy(torch, lambda: enc.encode_sequence(frames[4:8]))
    print(f"timed 4-frame session encode (IDR + 3 P): wall {wall:.1f} ms, {replays} "
          f"program replays {busy:.1f} ms on the device (CUDA events), device busy "
          f"{100 * busy / wall:.1f} % on {name}", flush=True)
    if enc.stats[-4]["idr"] is not True or any(st["idr"] for st in enc.stats[-3:]):
        raise AssertionError("the timed session frames are not an IDR and 3 P frames")
    print(capture_line("session", enc._programs, name), flush=True)
    print(eager_beside(torch, "session", lambda: Encoder(W, H, cfg, device=dev),
                       frames, name, 4), flush=True)

    print(f"[phase 9 done at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- 10. host path ----------------------------------------------------
    frames = content(N_HOST, W, H)
    stream, recon, host_runs, host_state, frame_s, k8_s, stats = host_path(
        torch, dev, frames)
    host_launches = host_runs["deblock_frame"]
    if host_launches != N_HOST:
        raise AssertionError(f"host path: K8 launched {host_launches} times for "
                             f"{N_HOST} frames")
    to_decode["host"] = (stream, recon, {"deblock": True})
    k8_host, _ = check_k8(torch, f"{W}x{H} host P state", host_state, QP)
    print(f"host path: {N_HOST} frames {W}x{H} QP{QP} deblock ({sum(s['idr'] for s in stats)} "
          f"IDR), {len(stream)} bytes, parses; K8 {host_launches / N_HOST:g} launches per "
          f"frame, K13 {host_runs['interp_planes']} (one a P frame), == plain on the last P "
          f"frame's state; e2e fps {N_HOST / sum(frame_s):.4f} on {name}", flush=True)
    for i, (fs, ks, st) in enumerate(zip(frame_s, k8_s, stats)):
        print(f"host frame {i} ({'IDR' if st['idr'] else 'P'}, {st['bytes']} bytes, mb types "
              f"{st['mb_types']}): {fs:.2f} s, host loop {fs - ks:.2f} s, K8 call "
              f"{1e3 * ks:.2f} ms on {name}", flush=True)
    t0 = time.perf_counter()
    qcif_host = host_qcif_streams(dev)
    check_host_qcif(qcif_host, name)
    on_cpu = host_qcif_streams("cpu")
    check_host_qcif(on_cpu, "the CPU")
    for key, (s_card, _) in qcif_host.items():
        if s_card != on_cpu[key][0]:
            raise AssertionError(f"host QCIF {key} stream on the card != CPU path stream")
    print(f"host QCIF: all-intra == the C++ reference's prefix, {len(HOST_QCIF)} streams == "
          f"their JAX digests, card == CPU ({time.perf_counter() - t0:.1f} s) on {name}",
          flush=True)
    # the --tpu-me path: K2 (SAD) + K9 against the plain chain, then the
    # host P frame searching the device's candidates
    t0 = time.perf_counter()
    k9_errs = [check_k9_maps(torch, dev)]
    for label, w, h in (("176x144", 176, 144), ("64x208", 64, 208)):
        y0, y1 = (torch.from_numpy(f[0]).to(dev) for f in content(2, w, h))
        k9_errs.append(check_me_topk(torch, label, y1, y0)[0][0])
    flat = torch.full((H, W), 128, dtype=torch.uint8, device=dev)
    k9_errs.append(check_me_topk(torch, f"{W}x{H} flat", flat, torch.full_like(flat, 121))[0][0])
    me_stream, me_recon, me_launches, me_s, me_stats, searched = me_topk_path(
        torch, dev, content(N_HOST, W, H))
    check_bytes("host_me_topk", me_stream)
    to_decode["host_me_topk"] = (me_stream, me_recon, {"deblock": True})
    src, plane0, ext, window, got = searched[-1]
    k9, want = check_me_topk(torch, f"{W}x{H} host P frame", src,
                             plane0[ext:-ext, ext:-ext].contiguous(), time_it=True)
    if window != WINDOW or max_err(torch, got, want):
        raise AssertionError("the --tpu-me path's candidates (plane 0 of its planes, ext "
                             f"{ext}) != the plain chain's")
    k9_errs.append(k9[0])
    full_p = [fs for fs, st in zip(frame_s, stats) if not st["idr"]]
    print(f"--tpu-me path: {N_HOST} frames {W}x{H} QP{QP} deblock, i16 IDR + host P on "
          f"the device's top-{TOPK} candidates, {len(me_stream)} bytes, parses; launches "
          f"{me_launches}; the path's candidates == the plain chain's; P frame "
          f"{me_s[-1]:.2f} s host (the full-search host P frame above: "
          f"{', '.join(f'{v:.2f}' for v in full_p)} s); stats {me_stats[-1]['mb_types']} "
          f"({time.perf_counter() - t0:.1f} s) on {name}", flush=True)

    print(f"[phase 10 done at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- 11. multi-device encoders and the band kernels ------------------
    t0 = time.perf_counter()
    frame = tuple(torch.from_numpy(p).to(dev) for p in content(1, W, H)[0])
    bk = {qp: check_band_kernels(torch, dev, frame, qp, time_it=qp == QP)
          for qp in CHECK_QPS}
    band_launches = multi_device_phase(torch, dev, name, to_decode)
    print(f"multi-device phase: {time.perf_counter() - t0:.1f} s on {name}", flush=True)

    print(f"[phase 11 done at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- 12. P-frame bands -----------------------------------------------
    t0 = time.perf_counter()
    k4b, band_p_launches, band_p_errs = p_band_phase(torch, dev, name, to_decode)
    print(f"P-band phase: {time.perf_counter() - t0:.1f} s on {name}", flush=True)

    print(f"[phase 12 done at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- 13. K10 vs its plain twins ---------------------------------------
    k10_rows, k10_fills = k10_phase(torch, dev, name)

    print(f"[phase 13 done at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- 14. K11 vs its plain twins ---------------------------------------
    k11_rows = k11_phase(torch, dev, name)

    print(f"[phase 14 done at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- 15. decode gate ----------------------------------------------------
    from h264_fer_tpu_torch.codec.decoder import Decoder

    decoded = {path: decode_gate(torch, dev, path, *to_decode[path], name)
               for path in ("all-intra", "IPPP", "mixed", "session", "host", "host_me_topk")}
    for i, qstream in enumerate(qcif_sessions):  # K8 on the card == its plain twin
        on_card, on_cpu = (list(Decoder(True, device=d).decode_annexb(qstream))
                           for d in (dev, "cpu"))
        if len(on_card) != len(on_cpu) or any(
                not np.array_equal(a, b) for fa, fb in zip(on_card, on_cpu)
                for a, b in zip(fa, fb)):
            raise AssertionError(f"QCIF session stream {i}: card decode != CPU decode")
    print(f"decode gate: {sum(v[0] for v in decoded.values())} frames of "
          f"{len(decoded)} 1080p streams == their reconstruction; QCIF session "
          f"decodes card == CPU on {name}", flush=True)

    print(f"[phase 15 done at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- 16. device programs against the eager launches ---------------------
    t0 = time.perf_counter()
    program_phase(torch, dev, name)
    print(f"program phase: {time.perf_counter() - t0:.1f} s on {name}", flush=True)

    print(f"[phase 16 done at {time.perf_counter() - t_start:.1f} s]", flush=True)
    # ---- 17. result -------------------------------------------------------
    csrc = "h264_fer_tpu_torch/kernels/csrc/"
    rows = [("wavefront_i16", "h264_fer_tpu/kernels/wavefront_pallas.py:890",
             k1_launches, max(k1[q][0] for q in CHECK_QPS), k1[QP][1:]),
            ("wavefront_i16_levels", "h264_fer_tpu/kernels/wavefront_pallas.py:173",
             launches, max(k1t[q][0] for q in CHECK_QPS), k1t[QP][1:]),
            ("deblock", "h264_fer_tpu/kernels/deblock_tpu.py:204",
             s_launches["deblock_frame"], max(k8_host[0], *(v[0] for v in k8.values())),
             k8["P", QP][1:]),
            ("me_int", "h264_fer_tpu/kernels/me_int_pallas.py:34",
             p_launches["integer_score_map"], None, None),
            ("me_qpel", "h264_fer_tpu/kernels/me_pallas.py:28",
             p_launches["qpel_refine_maps"], None, None),
            ("wavefront_p", "h264_fer_tpu/kernels/wavefront_p_pallas.py:60",
             p_launches["pframe_decide"], None, None),
            ("mc", "h264_fer_tpu/kernels/mc_pallas.py:42",
             p_launches["mc_bulk"], None, None)]
    for kname, replaces, n in (
            ("wavefront_i4x4", "h264_fer_tpu/kernels/wavefront_pallas.py:551",
             k4_launches),
            ("wavefront_mixed", "h264_fer_tpu/kernels/wavefront_mixed.py:54",
             m_launches["mixed_luma"]),
            ("wavefront_chroma", "h264_fer_tpu/kernels/wavefront.py:222",
             m_launches["chroma_frame"])):
        rows.append((kname, replaces, n, max(mk[q][kname][0] for q in CHECK_QPS),
                     mk[QP][kname][1:]))
    for kname, replaces in (
            ("wavefront_i16_levels_band", "h264_fer_tpu/parallel/tile.py:57"),
            ("wavefront_chroma_band", "h264_fer_tpu/kernels/wavefront.py:222"),
            ("wavefront_mixed_band", "h264_fer_tpu/kernels/wavefront_mixed.py:54")):
        rows.append((kname, replaces, band_launches[kname],
                     max(bk[q][kname][0] for q in CHECK_QPS), bk[QP][kname][1:]))
    rows.append(("wavefront_p_band", "h264_fer_tpu/kernels/wavefront_p.py:177",
                 band_p_launches["pframe_decide_band"], max(k4b[q][0] for q in P_QPS),
                 k4b[QP][1:]))
    # K12 and K13: their launches on the IPPP path, errors over phase 4's
    # inputs (every tier, the small grids, check_k12_k13's) and phase 12's bands
    for kname, stage, wrapper, replaces in (
            ("residual_p", "residual_recon", "residual_recon",
             "h264_fer_tpu/codec/tpu_pframe.py:343"),
            ("interp", "interp", "interp_planes", "h264_fer_tpu/ops/interp.py:131")):
        rows.append((kname, replaces, p_launches[wrapper],
                     max(k1213[stage], band_p_errs[stage], *(pk[q][stage][0] for q in P_QPS)),
                     pk[QP][stage][1:]))
    rows.append(("me_topk", "h264_fer_tpu/ops/me.py:56", me_launches["topk_candidates"],
                 max(k9_errs), k9[1:6]))
    # K10 by form: its launches on the all-intra (i16), IPPP (P) and mixed
    # (mixed, chroma setup) paths
    k10_runs = {"i16": k10_path["i16"], "p": p_launches, "mixed": m_launches,
                "chroma": m_launches}
    for form, (kname, replaces) in K10_ROWS.items():
        wrapper = k10_functions()[form][2].__name__
        rows.append((kname, replaces, k10_runs[form][wrapper], k10_rows[form][0],
                     k10_rows[form][1:]))
    # K11 by form: its launches on the all-intra (I16) and mixed (full) paths
    k11_runs = {"i16": k11_path["i16"], "full": m_launches}
    for form, (kname, replaces) in K11_ROWS.items():
        wrapper = k11_functions()[form][2].__name__
        rows.append((kname, replaces, k11_runs[form][wrapper], k11_rows[form][0],
                     k11_rows[form][1:]))
    library = {"me_topk": k9[6]}
    sources = {"wavefront_chroma": "wavefront_i16", "wavefront_i16_levels": "wavefront_i16",
               "wavefront_i16_levels_band": "wavefront_i16",
               "wavefront_chroma_band": "wavefront_i16",
               "wavefront_mixed_band": "wavefront_mixed", "wavefront_p_band": "wavefront_p",
               **{kname: "cavlc_slice" for kname, _ in K10_ROWS.values()},
               **{kname: "mode_decision" for kname, _ in K11_ROWS.values()}}
    kernels = []
    for kname, replaces, n, err, timing in rows:
        if timing is None:  # a P kernel: its QP 28 run, errors over all tiers
            err = max(pk[q][kname][0] for q in P_QPS)
            timing = pk[QP][kname][1:]
            if kname == "me_int":  # and K2's shapes of check_k2_shapes
                err = max(err, k2_err)
        ms, plain_ms, bound_ms, bound_by, queued_ms = timing
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"{csrc}{sources.get(kname, kname)}.cu",
            "replaces": replaces, "launches": n, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library.get(kname), "queued_ms": queued_ms})
        if kname == "deblock":  # K8 also runs on the host path and the decode path
            kernels[-1]["host_launches"] = host_launches
            kernels[-1]["decode_launches"] = decoded["session"][2]
        if kname == "me_int":  # K2 also searches the --tpu-me path's candidates and each band
            kernels[-1]["me_topk_path_launches"] = me_launches["integer_score_map"]
            kernels[-1]["band_launches"] = band_p_launches["integer_score_map"]
        if kname in ("residual_p", "interp"):  # one a band a P frame on the band paths
            kernels[-1]["band_launches"] = band_p_launches[
                "residual_recon" if kname == "residual_p" else "interp_planes"]
        if kname == "interp":  # one a host P frame on the host and --tpu-me paths
            kernels[-1]["host_launches"] = host_runs["interp_planes"]
            kernels[-1]["me_topk_path_launches"] = me_launches["interp_planes"]
        k10_form = {kn: form for form, (kn, _) in K10_ROWS.items()}.get(kname)
        if k10_form:  # K10's queued ms includes its workspace fill
            kernels[-1]["fill_queued_ms"] = k10_fills[k10_form]
    print(name)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
