"""Time the kernels of another checkout and of this one on one card, in
turns (other, this, this, other):

    python3 -m h264_fer_tpu_torch.kernels.compare_kernels OTHER_CHECKOUT

run from the root of this checkout, OTHER_CHECKOUT being, for example, the
parent commit unpacked with `git archive`. Each turn is a process of its
own started in one checkout's root (the two share module names); it builds
that checkout's kernels, times K2 (its block-order map; and as "K2 P
frame", the map in MB-quadrant order and its argmin, as a P frame takes
them: one launch where the checkout's K2 writes both, else K2 and the
eager argmin and blocks_to_mbq), K3, K4, K5, K6, K4x4, K1t, K1, K7
(through chroma_frame: recon and levels), K8 (on the session encoder's
P-frame state), K9 (the top-16 of K2's SAD map, metric 0 at window 8,
of the content pair's second luma plane against the first, edge-padded)
and, where the checkout has them, K10 in each form (on the slices of
chip_smoke.k10_frame_args), K11 in each form (the I16 and the full
mode decision of the content frame's uint8 luma plane, as the paths pass
it), K12 and K13 (on the chained P frame's residual / recon and reference
plane; K13 also as "K13 held", into a fresh output each call, every output
kept until the timing's end, as chip_smoke.py's kernels line times it,
where the other rows reuse the freed output, and as "K13 band", band 1 of
4 of the same reference) with CUDA events at
1920x1088, QP 28, on
chip_smoke.py's inputs (K2-K5 on the chained P frame), and reports a
checksum of each kernel's outputs, so that the turns also show both
checkouts compute the same function (a kernel one checkout lacks is
reported as absent there). Each
kernel is timed two ways, with the same code in both checkouts: "queued",
its calls issued behind a kernel that spins the card (the device's time
for the work, back to back), and "paced", its calls issued one after
another as the host gets to them (what the path sees when the host
issues more slowly than the card runs). A queued time is the device's
only where the spin outlasted the host's issue of every call: each
queued time comes with the host's issue time a call and whether the
spin covered it (its start event still pending once the last call was
issued).
Prints one line per turn and three per kernel.
"""

from __future__ import annotations

import json
import subprocess
import sys

TURN = r'''
import importlib.util, inspect, json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from h264_fer_tpu_torch.kernels.wavefront_p import pframe_decide
from h264_fer_tpu_torch.kernels.mc import mc_bulk
from h264_fer_tpu_torch.kernels.me_int import integer_score_map
from h264_fer_tpu_torch.kernels.wavefront_mixed import mixed_luma
from h264_fer_tpu_torch.kernels.wavefront_i4x4 import i4x4_luma
from h264_fer_tpu_torch.kernels.me_qpel import qpel_refine_maps
from h264_fer_tpu_torch.kernels.wavefront_i16 import chroma_frame, i16_frame, i16_recon
from h264_fer_tpu_torch.kernels.deblock import deblock_frame
from h264_fer_tpu_torch.kernels.me_topk import topk_candidates
from h264_fer_tpu_torch.ops.interp import edge_pad
from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig
from h264_fer_tpu_torch.ops.transform import chroma_qp
dev = torch.device("cuda")
pair = [tuple(torch.from_numpy(p).to(dev) for p in f) for f in cs.content(3, cs.W, cs.H)]
zero = torch.zeros(((cs.W // 16) * (cs.H // 16), 4, 2), dtype=torch.int32, device=dev)
_, _, o0 = cs.p_frame_stages(torch, cs.p_kernels(plain=False), pair[1], (*pair[0], zero), cs.QP)
_, args, _ = cs.p_frame_stages(torch, cs.p_kernels(plain=False), pair[2],
                               (*pair[1], o0["wavefront_p"]["mv"]), cs.QP)
frame = tuple(torch.from_numpy(p).to(dev) for p in cs.content(1, cs.W, cs.H)[0])
dec, cm, _, m = cs.mixed_inputs(torch, frame, cs.QP)
y, cb, cr = frame
qpc = chroma_qp(cs.QP)
m16 = dec["mode16"].to(torch.int32)
enc = Encoder(cs.W, cs.H, EncoderConfig(qp=cs.QP), device=dev)
for f in cs.content(2, cs.W, cs.H):
    enc.encode_frame(*f)
state = cs.encoder_state(enc)  # the P frame's state before the filter
sad_map = integer_score_map(pair[1][0], edge_pad(pair[0][0], cs.WINDOW).contiguous(),
                            cs.WINDOW, cs.WINDOW, 0)
if "p_frame" in inspect.signature(integer_score_map).parameters:  # K2 writes both
    def k2_p_frame():
        return integer_score_map(*args["me_int"][:5], p_frame=True)
else:  # K2's block-order map, then the eager argmin and order of codec/pframe.py
    from h264_fer_tpu_torch.codec.pframe import blocks_to_mbq

    def k2_p_frame():
        m = integer_score_map(*args["me_int"][:5])
        return (blocks_to_mbq(m, cs.W // 16, cs.H // 16).view(m.shape),
                m.argmin(dim=1).to(torch.int32))


def timed(fn, reps, queued):
    """(mean ms of fn() over reps calls between two CUDA events, the host's
    ms a call to issue them, whether the spin was still running when the
    last was issued): chip_smoke.cuda_ms's queued / paced timing at its
    first spin length, the same code in both checkouts."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(198_000 * reps)  # chip_smoke.QUEUE_CYCLES_PER_REP
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3 / reps
    covered = not start.query()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, issue_ms, covered


runs = {
    "K2": (lambda: integer_score_map(*args["me_int"][:5]), 20),
    "K2 P frame": (k2_p_frame, 20),
    "K3": (lambda: qpel_refine_maps(*args["me_qpel"]), 20),
    "K4": (lambda: pframe_decide(*args["wavefront_p"]), 20),
    "K5": (lambda: mc_bulk(*args["mc"]), 20),
    "K6": (lambda: mixed_luma(*m), 10),
    "K4x4": (lambda: i4x4_luma(y, m[2], cs.QP), 20),
    "K1t": (lambda: i16_frame(y, cb, cr, m16, cm, cs.QP, qpc), 20),
    "K1": (lambda: i16_recon(y, cb, cr, m16, cm, cs.QP, qpc), 20),
    "K7": (lambda: chroma_frame(cb, cr, cm, qpc), 20),
    "K8": (lambda: deblock_frame(*state, cs.QP, qpc), 20),
    "K9": (lambda: topk_candidates(sad_map, cs.WINDOW, cs.TOPK), 20),
}
if hasattr(cs, "k10_frame_args"):  # a checkout with K10
    fns = cs.k10_functions()
    planes = cs.content(1, cs.W, cs.H)[0]  # numpy, as k10_frame_args takes them
    for form, (a, kw) in cs.k10_frame_args(torch, dev, planes, pair, cs.QP).items():
        runs[f"K10 {form}"] = (lambda fn=fns[form][0], a=a, kw=kw:
                               fn(*a, cs.W // 16, cs.H // 16, **kw), 20)
if hasattr(cs, "k11_functions"):  # a checkout with K11
    for form, (fn, _, _) in cs.k11_functions().items():
        runs[f"K11 {form}"] = (lambda fn=fn: fn(y, cs.QP), 20)
if importlib.util.find_spec("h264_fer_tpu_torch.kernels.residual_p"):  # K12 and K13
    from h264_fer_tpu_torch.kernels.interp import interp_planes
    from h264_fer_tpu_torch.kernels.residual_p import residual_recon
    runs["K12"] = (lambda: residual_recon(*args["residual_recon"]), 20)
    runs["K13"] = (lambda: interp_planes(*args["interp"]), 20)
    held = []

    def k13_held():
        held.append(interp_planes(*args["interp"]))
        return held[-1]

    runs["K13 held"] = (k13_held, 20)
    # band 1 of 4 of the same reference (tile_p's window), as the P-band paths run it
    band = cs.band_reference((*pair[1], zero), 1, cs.P_BAND_TILES)[0].contiguous()
    runs["K13 band"] = (lambda: interp_planes(band, args["interp"][1], band=True), 20)
out = {}
for name, (fn, reps) in runs.items():
    res = fn()
    ts = list(res.values()) if isinstance(res, dict) else list(res)
    ts = [v for t in ts for v in (t.values() if isinstance(t, dict) else [t])]
    digest = sum(int(t.to(torch.int64).sum()) * (i + 1) for i, t in enumerate(ts))
    keep = name == "K13 held"  # its outputs kept: the allocator holds reps of them first
    if keep:
        [fn() for _ in range(reps)]
        held.clear()
    queued_ms, issue_ms, covered = timed(fn, reps, True)
    if keep:
        held.clear()
    paced_ms = timed(fn, reps, False)[0]
    if keep:
        held.clear()
    out[name] = (queued_ms, paced_ms, digest, issue_ms, covered)
print("RESULT " + json.dumps(out), flush=True)
'''


def turn(root: str) -> dict:
    """{kernel: (queued ms, paced ms, checksum, host issue ms a call of the
    queued timing, whether its spin covered the issue)} of the checkout at
    `root`."""
    proc = subprocess.run([sys.executable, "-c", TURN], cwd=root, capture_output=True,
                          text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode or not lines:
        raise RuntimeError(f"turn in {root} failed (exit {proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(lines[0][len("RESULT "):])


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other = argv[0]
    results = []
    for label, root in (("other", other), ("this", "."), ("this", "."), ("other", other)):
        res = turn(root)
        results.append((label, res))
        print(label, {k: (round(v[0], 4), round(v[1], 4)) for k, v in res.items()},
              flush=True)
    names = list(dict.fromkeys(k for _, r in results for k in r))
    for name in names:
        for i, how in ((0, "queued"), (1, "paced")):
            ms = {lab: [round(r[name][i], 4) for lb, r in results if lb == lab and name in r]
                  for lab in ("other", "this")}
            print(f"{name} {how}: "
                  + ", ".join(f"{lab} {f'{v} ms' if v else 'absent'}" for lab, v in ms.items()))
        print(f"{name} queued issue ms a call (covered by the spin): "
              + ", ".join(f"{lb} {r[name][3]:.4f} ({r[name][4]})"
                          for lb, r in results if name in r))
        absent = sorted({lab for lab, r in results if name not in r})
        same = len({r[name][2] for _, r in results if name in r}) == 1
        print(f"{name}: outputs equal across checkouts: {same}"
              + (f" (absent in {absent[0]})" if absent else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
