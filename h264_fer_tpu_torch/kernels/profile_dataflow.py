"""Phase profile of the one-launch wavefronts K4, K6, K4x4, K8, K1t and K7
on the card:

    python3 -m h264_fer_tpu_torch.kernels.profile_dataflow

run from the root of the checkout (it takes its inputs from chip_smoke.py:
1920x1088, QP 28; K8 on the session encoder's P-frame state). It copies
csrc/ into h264_fer_tpu_torch/_build/, adds clock64 stamps (thread 0 of
each block unless named, summed over the MBs) between the phases of each
MB and globaltimer stamps per MB (wait start, wait end, publish), builds
the copies with nvcc apart from the package's libraries, checks their
outputs against the real kernels, and prints per kernel: the mean cycles
per MB of each phase, the flag hop (wait end after the last waited
neighbour's publish) and the time per step of the critical path (a knight
diagonal d = c + 2r for K4, K6, K4x4 and K8, an anti-diagonal d = r + c for
K1t and K7, which share one instrumented build). The stamps cost time of their own: the phase split, not the total,
is what it measures. K4x4 waits per 4x4-block step on its neighbours'
edge slots, not per MB: its report gives the cycles of each step's wait,
of the body without them and of its publishes, the hop of the left edge's
first slot and the time per knight diagonal.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import numpy as np
import torch

from . import build, dataflow

PROF_DIR = build.BUILD_DIR / "profile"

HEAD = r'''
__device__ unsigned long long g_prof[32];
__device__ unsigned long long g_ts[4][8160];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
#define PROF(k) if (threadIdx.x == 0) { long long _n = clock64(); \
  atomicAdd(&g_prof[k], (unsigned long long)(_n - _pt)); _pt = _n; }
#define TS(i) if (threadIdx.x == 0) g_ts[i][mb] = gtime();
extern "C" int prof_read(unsigned long long* p, unsigned long long* ts) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(p, g_prof, sizeof(g_prof));
  return (int)cudaMemcpyFromSymbol(ts, g_ts, sizeof(g_ts)); }
extern "C" int prof_reset() {
  static unsigned long long z[32 + 4 * 8160];
  cudaMemcpyToSymbol(g_prof, z, sizeof(g_prof));
  return (int)cudaMemcpyToSymbol(g_ts, z, sizeof(g_ts)); }
'''

# (text in the source, text that replaces it); each must occur once
K4_STAMPS = [
    ("  for (;;) {\n", "  for (;;) {\n    long long _pt = clock64();\n"),
    ("    if (mb < 0) return;\n", "    if (mb < 0) return;\n    PROF(0)\n"),
    ("    cp_async_wait_all();\n", "    cp_async_wait_all();\n    PROF(1) TS(0)\n"),
    ("    dataflow_wait(df, r, c, f.wmb);\n",
     "    PROF(2)\n    dataflow_wait(df, r, c, f.wmb);\n    PROF(3) TS(1)\n"),
    ("    __syncwarp();\n    const State* nbs = s_nb;\n",
     "    __syncwarp();\n    PROF(4)\n    const State* nbs = s_nb;\n"),
    ("      predict(own, nbs, 4, q, &mx, &my);\n",
     "      predict(own, nbs, 4, q, &mx, &my);\n      PROF(5)\n"),
    ("      warp_argmin(&best, &bk);\n", "      PROF(6)\n      warp_argmin(&best, &bk);\n      PROF(7)\n"),
    ("    // ---- mb_type merge", "    PROF(8)\n    // ---- mb_type merge"),
    ("    dataflow_publish(df, mb);\n", "    dataflow_publish(df, mb);\n    PROF(9) TS(2)\n"),
    ("    f.skip[mb] = is_skip;\n",
     "    f.skip[mb] = is_skip;\n    PROF(10) atomicAdd(&g_prof[31], 1ull);\n"),
]
K4_PHASES = {0: "ticket", 1: "source and centres land", 2: "candidate tables",
             3: "wait", 4: "neighbour state", 5: "4 predictors (+ window loads)",
             6: "4 candidate loops", 7: "4 argmin reductions", 8: "unify",
             9: "merge, state, publish", 10: "mvd and outputs"}

K6_STAMPS = [
    ("  for (;;) {\n", "  for (;;) {\n    long long _pt = clock64();\n"),
    ("    if (mb < 0) return;\n", "    if (mb < 0) return;\n    PROF(0)\n"),
    ("    cp_async_wait_all();\n", "    cp_async_wait_all();\n    PROF(1) TS(0)\n"),
    ("    dataflow_wait(df, r, c, f.wmb);\n", "    dataflow_wait(df, r, c, f.wmb);\n    PROF(2) TS(1)\n"),
    ("    if (t == 99) i4_t = top_ok && f.choice4[mb_t];\n    __syncthreads();\n",
     "    if (t == 99) i4_t = top_ok && f.choice4[mb_t];\n    __syncthreads();\n    PROF(3)\n"
     "    long long _c = clock64();\n"),
    ("      i4x4_mb(s_src, m4, nb, f.qp, f.tab, lv_4, sc, lane);\n",
     "      i4x4_mb(s_src, m4, nb, f.qp, f.tab, lv_4, sc, lane);\n"
     "      if (t == 256) atomicAdd(&g_prof[21], (unsigned long long)(clock64() - _c));\n"),
    ("                          16, f.qp, f.tab, s16, lv_dc, lv_ac, t, 1);\n",
     "                          16, f.qp, f.tab, s16, lv_dc, lv_ac, t, 1);\n"
     "      if (t == 0) atomicAdd(&g_prof[20], (unsigned long long)(clock64() - _c));\n"),
    ("    __syncthreads();\n\n    // ---- the choice",
     "    if (t == 256) atomicAdd(&g_prof[22], (unsigned long long)(clock64() - _c));\n"
     "    __syncthreads();\n    PROF(4)\n\n    // ---- the choice"),
    ("    dataflow_publish(df, mb);\n", "    dataflow_publish(df, mb);\n    PROF(9) TS(2)\n"),
    ("      f.rem_modes[16 * mb + t] = s_rm[t];\n    }\n",
     "      f.rem_modes[16 * mb + t] = s_rm[t];\n    }\n"
     "    PROF(10) if (t == 0) atomicAdd(&g_prof[31], 1ull);\n"),
]
K6_PHASES = {0: "ticket", 1: "prefetch", 2: "wait", 3: "neighbour state",
             4: "candidates and their sizes", 9: "choice, state, publish",
             10: "outputs", 20: "I16 candidate (thread 0)",
             21: "I4x4 candidate (thread 256)", 22: "I4x4 and its sizes (thread 256)"}

K4X4_STAMPS = [
    # the hook carries its MB's index for the stamps below
    ("  int need, lane;\n", "  int need, lane, mb;\n"),
    ("kNeed[lane] : 0, lane, false};\n", "kNeed[lane] : 0, lane, mb, false};\n"),
    ("  for (;;) {\n", "  for (;;) {\n    long long _pt = clock64();\n"),
    ("    if (mb < 0) return;\n", "    if (mb < 0) return;\n    PROF(0)\n"),
    ("    cp_async_wait_all();\n    __syncwarp();\n",
     "    cp_async_wait_all();\n    __syncwarp();\n    PROF(1)\n"),
    ("    i4x4_mb(s_src, m4, nb, f.qp, f.tab, f.levels + 256 * mb, sc, lane, hook);\n",
     "    i4x4_mb(s_src, m4, nb, f.qp, f.tab, f.levels + 256 * mb, sc, lane, hook);\n"
     "    PROF(2)\n"),
    ("      *reinterpret_cast<uint2*>(f.yrec + (size_t)(y0 + y) * W + x0 + x) = v;\n    }\n",
     "      *reinterpret_cast<uint2*>(f.yrec + (size_t)(y0 + y) * W + x0 + x) = v;\n    }\n"
     "    PROF(3) TS(3) if (threadIdx.x == 0) atomicAdd(&g_prof[31], 1ull);\n"),
    # the waits of each step, on lane 0 (from the hook's start to its barrier)
    ("    if (t == 5 || t > 6) return;  // steps that read no new neighbour slot\n",
     "    if (t == 5 || t > 6) return;  // steps that read no new neighbour slot\n"
     "    long long _w = clock64();\n"),
    ("    __syncwarp();\n  }\n\n  // lane `who` publishes",
     "    __syncwarp();\n    if (lane == 0) atomicAdd(&g_prof[10 + t], (unsigned long long)"
     "(clock64() - _w));\n  }\n\n  // lane `who` publishes"),
    # the left edge's first slot: its publish, and the right neighbour's wait for it
    ("    bool wait = mine != nullptr && !got && need <= t;\n",
     "    bool wait = mine != nullptr && !got && need <= t;\n"
     "    if (t == 0 && lane == 0 && wait) g_ts[1][mb] = gtime();\n"),
    ("    got = true;\n", "    got = true;\n    if (lane == 0) g_ts[2][mb] = gtime();\n"),
    ("    st_relaxed64(own + k, 1ull << 32 | v);\n",
     "    st_relaxed64(own + k, 1ull << 32 | v);\n    if (k == 0) g_ts[0][mb] = gtime();\n"),
    # lane 0's publishes (it makes 6 of the MB's 8)
    ("  __device__ __forceinline__ void after(int t) const {\n    if (t == 3) publish(0, 0);\n",
     "  __device__ __forceinline__ void after(int t) const {\n    long long _a = clock64();\n"
     "    if (t == 3) publish(0, 0);\n"),
    ("      publish(1, 7);\n    }\n  }\n};\n",
     "      publish(1, 7);\n    }\n    if (lane == 0) atomicAdd(&g_prof[20], (unsigned long long)"
     "(clock64() - _a));\n  }\n};\n"),
]
K4X4_WAITS = {10 + t: f"wait before step {t} (lane 0)" for t in (0, 1, 2, 3, 4, 6)}
K4X4_PHASES = {0: "ticket", 1: "source, modes, borders", 2: "10 steps with their waits",
               3: "recon store", **K4X4_WAITS, 20: "publishes (lane 0, in the steps)"}

K8_STAMPS = [
    ("  for (;;) {\n", "  for (;;) {\n    long long _pt = clock64();\n"),
    ("    if (mb < 0) return;\n", "    if (mb < 0) return;\n    PROF(0)\n"),
    ("    dataflow_wait(df, r, c, wmb);  // left, top, top-right, top-left\n",
     "    PROF(1) TS(0)\n    dataflow_wait(df, r, c, wmb);  // left, top, top-right, top-left\n"
     "    PROF(2) TS(1)\n"),
    ("      // vertical edges left to right", "      PROF(3)\n      // vertical edges left to right"),
    ("      // ---- write back what the filter can change",
     "      PROF(4)\n      // ---- write back what the filter can change"),
    ("    dataflow_publish(df, mb);\n  }\n}\n",
     "    dataflow_publish(df, mb);\n    PROF(5) TS(2) if (threadIdx.x == 0) atomicAdd(&g_prof[31], 1ull);\n"
     "  }\n}\n"),
]
K8_PHASES = {0: "ticket", 1: "own samples and bS", 2: "wait", 3: "luma strip loads",
             4: "8 luma edge steps", 5: "write-back, chroma, publish"}

K1T_STAMPS = [
    ("  const int W = f.wmb * 16, Wc = f.wmb * 8;\n\n  for (;;) {\n"
     "    const int mb = dataflow_next(df, &s_mb);\n    if (mb < 0) return;\n",
     "  const int W = f.wmb * 16, Wc = f.wmb * 8;\n\n  for (;;) {\n"
     "    long long _pt = clock64();\n"
     "    const int mb = dataflow_next(df, &s_mb);\n    if (mb < 0) return;\n    PROF(0)\n"),
    ("    dataflow_wait<kIntraSet>(df, r, c, f.wmb);  // left, top, top-left\n",
     "    PROF(1) TS(0)\n    dataflow_wait<kIntraSet>(df, r, c, f.wmb);  // left, top, top-left\n"
     "    PROF(2) TS(1)\n    long long _c = clock64();\n"),
    ("      group_sync(1, 256);\n      const int v = i16_luma_mb(",
     "      group_sync(1, 256);\n      PROF(3)\n      const int v = i16_luma_mb("),
    ("      f.yrec[(size_t)(y0 + (t >> 4)) * W + x0 + (t & 15)] = (uint8_t)v;\n",
     "      f.yrec[(size_t)(y0 + (t >> 4)) * W + x0 + (t & 15)] = (uint8_t)v;\n      PROF(4)\n"),
    ("                f.lv.cac ? f.lv.cac + mb * 60 : nullptr, f.nmb, t - 256, 2);\n",
     "                f.lv.cac ? f.lv.cac + mb * 60 : nullptr, f.nmb, t - 256, 2);\n"
     "      if (t == 256) atomicAdd(&g_prof[20], (unsigned long long)(clock64() - _c));\n"),
    ("    dataflow_publish(df, mb);\n  }\n}\n",
     "    dataflow_publish(df, mb);\n    PROF(5) TS(2) if (threadIdx.x == 0) atomicAdd(&g_prof[31], 1ull);\n"
     "  }\n}\n"),
]
K1T_PHASES = {0: "ticket", 1: "source and modes land", 2: "wait", 3: "neighbour loads",
              4: "luma code and store", 5: "wait for chroma, publish",
              20: "chroma code and store (thread 256)"}

K7_STAMPS = [
    ("  const int Wc = f.wmb * 8;\n\n  for (;;) {\n"
     "    const int mb = dataflow_next(df, &s_mb);\n    if (mb < 0) return;\n",
     "  const int Wc = f.wmb * 8;\n\n  for (;;) {\n    long long _pt = clock64();\n"
     "    const int mb = dataflow_next(df, &s_mb);\n    if (mb < 0) return;\n    PROF(0)\n"),
    ("    cp_async_wait_all();\n"
     "    dataflow_wait<kIntraSet>(df, r, c, f.wmb);  // left, top, top-left: chroma\n",
     "    cp_async_wait_all();\n    PROF(1) TS(0)\n"
     "    dataflow_wait<kIntraSet>(df, r, c, f.wmb);  // left, top, top-left: chroma\n"
     "    PROF(2) TS(1)\n"),
    ("              f.cac ? f.cac + mb * 60 : nullptr, f.nmb, t, 1);\n",
     "              f.cac ? f.cac + mb * 60 : nullptr, f.nmb, t, 1);\n    PROF(3)\n"),
    ("    dataflow_publish(df, mb);  // the MB's chroma is final\n",
     "    dataflow_publish(df, mb);  // the MB's chroma is final\n"
     "    PROF(4) TS(2) if (threadIdx.x == 0) atomicAdd(&g_prof[31], 1ull);\n"),
]
K7_PHASES = {0: "ticket", 1: "source and mode land", 2: "wait",
             3: "neighbour loads, chroma code, store", 4: "publish"}

FOUR = ((0, -1), (-1, 0), (-1, 1), (-1, -1))  # left, top, top-right, top-left
I16_SET = ((0, -1), (-1, 0), (-1, -1))         # left, top, top-left


def instrumented(name: str, stamps) -> ctypes.CDLL:
    """csrc/<name>.cu with `stamps` applied, built into PROF_DIR."""
    shutil.rmtree(PROF_DIR, ignore_errors=True)
    shutil.copytree(build.CSRC, PROF_DIR)
    src = PROF_DIR / f"{name}.cu"
    text = src.read_text()
    for old, new in stamps:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}.cu: stamp anchor {old!r} found {text.count(old)} times")
        text = text.replace(old, new)
    text = text.replace('#include "mb_dataflow.cuh"\n', '#include "mb_dataflow.cuh"\n' + HEAD, 1)
    src.write_text(text)
    lib = PROF_DIR / f"lib{name}-profile.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"build of the profiled {name} failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def call(lib, symbol: str, args) -> None:
    """The C entry point with `args` as build.launch passes them."""
    ints = [isinstance(a, (int, np.integer)) for a in args]
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_int if n else ctypes.c_void_p for n in ints] + [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    ptrs = [int(a) if n else a.ctypes.data if isinstance(a, np.ndarray) else a.data_ptr()
            for a, n in zip(args, ints)]
    launched = ctypes.c_int(0)
    err = fn(*ptrs, torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
    if err:
        raise RuntimeError(f"{symbol}: CUDA error {err}")


def report(lib, label: str, wmb: int, hmb: int, phases: dict, run, neighbours=FOUR,
           dr: int = 2) -> None:
    run()
    lib.prof_reset()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    acc = np.zeros(32, np.uint64)
    ts = np.zeros((4, 8160), np.uint64)
    lib.prof_read(acc.ctypes.data, ts.ctypes.data)
    n = max(int(acc[31]), 1)
    print(f"{label}: {start.elapsed_time(end):.4f} ms with stamps, {n} MBs; "
          "mean cycles per MB (thread 0 unless named):")
    for i, phase in phases.items():
        print(f"  {phase:34s} {acc[i] / n:10.1f}")
    nmb = wmb * hmb
    wait_start, wait_end, pub = (ts[i, :nmb].astype(np.int64) for i in range(3))
    hops = []
    for mb in range(nmb):
        r, c = divmod(mb, wmb)
        deps = [(r + nr) * wmb + c + nc for nr, nc in neighbours
                if r + nr >= 0 and 0 <= c + nc < wmb]
        last = max((pub[d] for d in deps), default=-1)
        if last > wait_start[mb]:
            hops.append(wait_end[mb] - last)
    hops = np.array(hops)
    d = np.array([mb % wmb + dr * (mb // wmb) for mb in range(nmb)])
    step = np.diff([pub[d == k].max() for k in range(d.max() + 1)])
    print(f"  flag hop ns: median {np.median(hops):.0f}, p90 {np.percentile(hops, 90):.0f} "
          f"({hops.size} MBs waited); wait end to publish ns: median "
          f"{np.median(pub - wait_end):.0f}; per {'knight' if dr == 2 else 'anti-'}diagonal "
          f"ns: median {np.median(step):.0f}", flush=True)


def report_steps(lib, label: str, wmb: int, hmb: int, phases: dict, run) -> None:
    """report() for K4x4, whose MBs wait per step on their neighbours' edge
    slots: the phases and the waits of each step, the hop of the left
    edge's first slot (the right neighbour's fetch end after the slot's
    publish, where the fetch started first) and the time per knight
    diagonal of the MBs' completion."""
    run()
    lib.prof_reset()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    acc = np.zeros(32, np.uint64)
    ts = np.zeros((4, 8160), np.uint64)
    lib.prof_read(acc.ctypes.data, ts.ctypes.data)
    n = max(int(acc[31]), 1)
    print(f"{label}: {start.elapsed_time(end):.4f} ms with stamps, {n} MBs; "
          "mean cycles per MB (lane 0):")
    for i, phase in phases.items():
        print(f"  {phase:34s} {acc[i] / n:10.1f}")
    body = (int(acc[2]) - sum(int(acc[i]) for i in K4X4_WAITS)) / n
    print(f"  {'10 steps less the waits (body)':34s} {body:10.1f}")
    nmb = wmb * hmb
    pub, fetch0, fetch1, done = (ts[i, :nmb].astype(np.int64) for i in range(4))
    mbs = [mb for mb in range(nmb) if mb % wmb and fetch0[mb] < pub[mb - 1]]
    hops = np.array([fetch1[mb] - pub[mb - 1] for mb in mbs] or [0])
    d = np.array([mb % wmb + 2 * (mb // wmb) for mb in range(nmb)])
    step = np.diff([done[d == k].max() for k in range(d.max() + 1)])
    print(f"  left-slot hop ns: median {np.median(hops):.0f}, p90 "
          f"{np.percentile(hops, 90):.0f} ({hops.size} MBs waited); per knight diagonal "
          f"ns: median {np.median(step):.0f}", flush=True)


def main() -> int:
    import chip_smoke as cs  # the checkout's root is on sys.path under -m
    from ..codec.encoder import Encoder, EncoderConfig
    from ..ops.transform import chroma_qp
    from .deblock import _edge_params, deblock_frame
    from .wavefront_i16 import chroma_frame, i16_frame, qtab
    from .wavefront_i4x4 import PRED4_TABLE, i4x4_luma
    from .wavefront_i4x4 import scratch as i4x4_scratch
    from .wavefront_mixed import KEYS, TABLES, mixed_luma
    from ..ops.device import const

    print(cs.card(), flush=True)
    dev = torch.device("cuda")
    pair = [tuple(torch.from_numpy(p).to(dev) for p in f) for f in cs.content(3, cs.W, cs.H)]
    zero = torch.zeros(((cs.W // 16) * (cs.H // 16), 4, 2), dtype=torch.int32, device=dev)
    kern = cs.p_kernels(plain=False)
    _, _, o0 = cs.p_frame_stages(torch, kern, pair[1], (*pair[0], zero), cs.QP)
    _, args, outs = cs.p_frame_stages(torch, kern, pair[2],
                                      (*pair[1], o0["wavefront_p"]["mv"]), cs.QP)
    a = args["wavefront_p"]
    wmb, hmb, window, ext, metric, lam = a[9:]
    nmb = wmb * hmb
    lib4 = instrumented("wavefront_p", K4_STAMPS)

    def k4():
        o = [torch.empty(nmb, dtype=torch.bool, device=dev),
             torch.empty(nmb, dtype=torch.int32, device=dev),
             torch.empty((nmb, 4, 2), dtype=torch.int32, device=dev),
             torch.empty((nmb, 4, 2), dtype=torch.int32, device=dev),
             torch.empty(nmb, dtype=torch.int32, device=dev)]
        order, sched = dataflow.schedule(dataflow.knight_order(wmb, hmb), dev)
        call(lib4, "wavefront_p_frame", (*a[:9], *o, order, sched, 16 * wmb, hmb, window,
                                         ext, metric, lam, 0))
        return dict(zip(("skip", "mb_type", "mv", "mvd"), o))

    got = k4()
    if not all(torch.equal(got[k], outs["wavefront_p"][k]) for k in got):
        raise AssertionError("profiled K4 != K4")
    report(lib4, f"K4 {cs.W}x{cs.H} qp{cs.QP}", wmb, hmb, K4_PHASES, k4)

    frame = tuple(torch.from_numpy(p).to(dev) for p in cs.content(1, cs.W, cs.H)[0])
    _, _, _, m = cs.mixed_inputs(torch, frame, cs.QP)
    want = mixed_luma(*m)
    lib6 = instrumented("wavefront_mixed", K6_STAMPS)

    def k6():
        out = {k: torch.empty_like(want[k]) for k in KEYS}
        order, sched = dataflow.schedule(dataflow.knight_order(wmb, hmb), dev)
        call(lib6, "wavefront_mixed_frame",
             (*m[:6], const(TABLES, dev), const(PRED4_TABLE, dev), *(out[k] for k in KEYS),
              order, sched, wmb, hmb, cs.QP, qtab(cs.QP), 0))
        return out

    got = k6()
    if not all(torch.equal(got[k], want[k]) for k in KEYS):
        raise AssertionError("profiled K6 != K6")
    report(lib6, f"K6 {cs.W}x{cs.H} qp{cs.QP}", wmb, hmb, K6_PHASES, k6)

    y = frame[0]
    want = i4x4_luma(y, m[2], cs.QP)  # in the decided Intra4x4 modes
    lib4x4 = instrumented("wavefront_i4x4", K4X4_STAMPS)

    def k4x4():
        out = [torch.empty_like(t) for t in want]
        call(lib4x4, "wavefront_i4x4_frame",
             (y, m[2], const(PRED4_TABLE, dev), *out, i4x4_scratch(nmb, dev),
              const(dataflow.knight_order(wmb, hmb), dev), wmb, hmb, cs.QP,
              qtab(cs.QP), 0))
        return out

    if not all(torch.equal(g, w) for g, w in zip(k4x4(), want)):
        raise AssertionError("profiled K4x4 != K4x4")
    report_steps(lib4x4, f"K4x4 {cs.W}x{cs.H} qp{cs.QP}", wmb, hmb, K4X4_PHASES, k4x4)

    enc = Encoder(cs.W, cs.H, EncoderConfig(qp=cs.QP), device=dev)
    for f in cs.content(2, cs.W, cs.H):
        enc.encode_frame(*f)
    state = cs.encoder_state(enc)  # the P frame's, as chip_smoke's K8 timing
    want = deblock_frame(*state, cs.QP, chroma_qp(cs.QP))
    tab = np.array([v for a, b, tc0 in (_edge_params(cs.QP), _edge_params(chroma_qp(cs.QP)))
                    for v in (a, b, *tc0)], dtype=np.int32)
    lib8 = instrumented("deblock", K8_STAMPS)

    def k8():
        out = tuple(p.clone() for p in state[:3])
        order, sched = dataflow.schedule(dataflow.knight_order(wmb, hmb), dev)
        call(lib8, "deblock_frame", (*out, *state[3:], order, sched, wmb, hmb, tab, 0))
        return out

    if not all(torch.equal(g, w) for g, w in zip(k8(), want)):
        raise AssertionError("profiled K8 != K8")
    report(lib8, f"K8 {cs.W}x{cs.H} qp{cs.QP} P state", wmb, hmb, K8_PHASES, k8)

    y, cb, cr = frame
    # the I16 modes and chroma modes of mixed_inputs
    m16, cm = (t.to(torch.int32).contiguous() for t in (m[1], m[3]))
    want = i16_frame(y, cb, cr, m16, cm, cs.QP, chroma_qp(cs.QP))
    lib1 = instrumented("wavefront_i16", K1T_STAMPS + K7_STAMPS)

    def k1t():
        out = [torch.empty_like(t) for t in want]
        order, sched = dataflow.schedule(dataflow.diagonal_order(wmb, hmb), dev)
        call(lib1, "wavefront_i16_frame_levels",
             (y, cb, cr, m16, cm, out[0], out[3], out[4], out[1], out[2], out[5], out[6],
              order, sched, wmb, hmb, cs.QP, chroma_qp(cs.QP),
              np.concatenate([qtab(cs.QP), qtab(chroma_qp(cs.QP))]), 0))
        return out

    if not all(torch.equal(g, w) for g, w in zip(k1t(), want)):
        raise AssertionError("profiled K1t != K1t")
    report(lib1, f"K1t {cs.W}x{cs.H} qp{cs.QP}", wmb, hmb, K1T_PHASES, k1t, I16_SET, 1)

    qpc = chroma_qp(cs.QP)
    want = chroma_frame(cb, cr, cm, qpc)

    def k7():
        out = [torch.empty_like(t) for t in want]
        order, sched = dataflow.schedule(dataflow.diagonal_order(wmb, hmb), dev)
        call(lib1, "wavefront_chroma_frame_levels",
             (cb, cr, cm, *out, order, sched, wmb, hmb, qpc, qtab(qpc), 0))
        return out

    if not all(torch.equal(g, w) for g, w in zip(k7(), want)):
        raise AssertionError("profiled K7 != K7")
    report(lib1, f"K7 {cs.W}x{cs.H} qp{cs.QP}", wmb, hmb, K7_PHASES, k7, I16_SET, 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
