"""The device programs (codec/program.py) in their plain form on the CPU:
each of the four programs (the whole-GOP IPPP program at 1, 2 and 4
frames, the I16 and mixed frame programs, the session's IDR and P frame
programs) runs twice on the same slots with different QCIF frames, and
each run equals the port's eager functions on fresh tensors; the payloads
a call copied out survive the next call; the warm-up before a capture
leaves a program's state slots as they were; two lanes hold two instances
of one key, and the key separates QP, size and GOP length; a CUDA request
without a card raises. No JAX: the eager functions are held to the JAX
package by tests/test_torch_ippp.py, test_torch_iframe.py,
test_torch_mixed.py and test_torch_encoder*.py, which now run through the
programs' plain form."""

import numpy as np
import pytest
import torch

from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig
from h264_fer_tpu_torch.codec.encoder_host import INTRA_CLASS, SKIP_CLASS
from h264_fer_tpu_torch.codec.gop import device_gop_ippp, restore_dropped, trailing_skip_drop
from h264_fer_tpu_torch.codec.iframe import device_i16_frame, device_mixed_frame
from h264_fer_tpu_torch.codec.pframe import device_p_frame
from h264_fer_tpu_torch.codec.program import DeviceProgram, planes
from h264_fer_tpu_torch.kernels.deblock import deblock_frame
from h264_fer_tpu_torch.ops.device import upload_into
from h264_fer_tpu_torch.ops.transform import chroma_qp
from h264_fer_tpu_torch.parallel.gop_device import (GOP_PROGRAMS, GopIntraEncoder,
                                                    GopIpppEncoder, Lane)
from h264_fer_tpu_torch.vio.y4m import Y4MReader

torch.set_num_threads(1)

W, H, QP = 176, 144, 28
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))


def _tensors(frames):
    """Fresh CPU tensors of each frame's planes."""
    return [tuple(torch.from_numpy(np.array(p)) for p in f) for f in frames]


def _equal(got, want):
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_gop_program_equals_eager_gop(clip, n):
    """Two GOPs of n frames through one program (frames 0.. and 5..): each
    call's words, nbits, per-frame reference planes and final state equal
    device_gop_ippp on fresh tensors; the first call's copied payloads
    survive the second."""
    enc = GopIpppEncoder(W, H, QP, gop_len=4, device="cpu")
    prog = enc._program(enc.lanes[0], n)
    assert prog.keep == ("words", "nbits") and not prog.graph
    calls = []
    for start in (0, 5):
        frames = clip[start: start + n]
        for k, name in enumerate(("ys", "cbs", "crs")):
            upload_into(prog.slots[name], [f[k] for f in frames])
        got = prog(keep=("words", "nbits", "recon"))
        ys, cbs, crs = zip(*_tensors(frames))
        want = device_gop_ippp(ys, cbs, crs, enc.hdr_bits[: n - 1], enc.window, QP,
                               enc.qpc, enc.maxdiff, enc.prefilter)
        for j, f in enumerate(want["frames"]):
            _equal(got["words"][j], f["words"])
            _equal(got["nbits"][j], f["nbits"])
            for g, w in zip(got["recon"][3 * j: 3 * j + 3], f["recon"]):
                _equal(g, w)
        for key in ("recon_y", "recon_cb", "recon_cr", "mv"):
            _equal(got[key], want[key])
        calls.append((got, want))
    (first, want), (second, _) = calls
    assert not torch.equal(first["nbits"], second["nbits"])
    for j, f in enumerate(want["frames"]):
        _equal(first["words"][j], f["words"])
        _equal(first["recon"][3 * j], f["recon"][0])
    # the outputs not kept are the static ones: the second call's
    assert first["recon_y"] is second["recon_y"]


@pytest.mark.parametrize("mode", ["i16", "mixed"])
def test_frame_program_equals_eager_frame(clip, mode):
    """The I16 and mixed frame programs on frames 0 and 7: every output
    equals device_i16_frame / device_mixed_frame on fresh tensors; the first
    call's payload (and recon) survive the second call."""
    enc = GopIntraEncoder(W, H, QP, mode=mode, device="cpu")
    frame_fn = device_mixed_frame if mode == "mixed" else device_i16_frame
    prog = enc._program(enc.lanes[0])
    outs = []
    for f in (clip[0], clip[7]):
        got = prog(keep=("words", "nbits", "recon_y", "recon_cb", "recon_cr"),
                   **dict(zip(("y", "cb", "cr"), _tensors([f])[0])))
        want = frame_fn(*_tensors([f])[0], QP, chroma_qp(QP))
        assert sorted(got) == sorted(want)
        for key in want:
            _equal(got[key], want[key])
        outs.append((got, want))
    (first, want), (second, _) = outs
    assert not torch.equal(first["nbits"], second["nbits"])
    for key in ("words", "nbits", "recon_y", "recon_cb", "recon_cr"):
        _equal(first[key], want[key])


def _eager_session(frames, cfg, hdr_bits):
    """The session's device frames as the eager chain: the IDR (filtered),
    then each P frame, its trailing-skip drop, the MB-state updates and
    the filter. Returns per frame (words, nbits, ref planes, mv, mb_class,
    nz)."""
    qpc = chroma_qp(cfg.qp)
    out = []
    for i, (y, cb, cr) in enumerate(_tensors(frames)):
        if i % cfg.intra_every == 0:
            f = device_i16_frame(y, cb, cr, cfg.qp, qpc, deblock=cfg.deblock)
            ref = (f["recon_y"], f["recon_cb"], f["recon_cr"])
            mv = torch.zeros((W * H // 256, 4, 2), dtype=torch.int32)
            cls = torch.full((W * H // 256,), INTRA_CLASS, dtype=torch.int32)
            nz = f["nz_luma"]
        else:
            f = device_p_frame(y, cb, cr, *ref, mv, cfg.window_size // 2, cfg.qp, qpc,
                               cfg.maxdiff, cfg.qp < 36)
            keep = trailing_skip_drop(f["skip"], f["nbits"], f["trail_bits"], hdr_bits)
            *ref, mv = restore_dropped(keep, (*ref, mv), f)
            cls = torch.where(keep, cls, torch.where(
                f["skip"], SKIP_CLASS, f["raw_type"].clamp(max=4))).to(torch.int32)
            nz = torch.where(keep[:, None], nz, f["nz_luma"])
            ref = deblock_frame(*ref, cls == INTRA_CLASS, nz, mv, cfg.qp, qpc)
        out.append((f["words"], f["nbits"], tuple(ref), mv, cls, nz))
    return out


def test_session_programs_equal_eager_frames(clip):
    """The session's IDR and P programs, each run twice (frames IDR, P, P,
    IDR, P at intra_every 3, deblock): every payload and the state after
    every frame equal the eager chain on fresh tensors; the programs are
    two, keyed by frame type."""
    cfg = EncoderConfig(qp=QP, intra_every=3, deblock=True)
    frames = clip[:5]
    enc = Encoder(W, H, cfg, device="cpu")
    hdr_bits = None
    got = []
    for f in frames:
        enc.encode_frame(*f)
        kind = "idr" if enc.stats[-1]["idr"] else "p"
        prog = [p for key, p in enc._programs.items() if key[0] == kind][0]
        if kind == "p":
            hdr_bits = next(key for key in enc._programs if key[0] == "p")[8]  # baked in
        out = prog.outputs
        got.append((out["words"].clone(), out["nbits"].clone(),
                    tuple(p.clone() for p in enc._ref), enc._mv.clone(),
                    enc._mb_class.clone(), enc._nz.clone()))
    assert len(enc._programs) == 2
    want = _eager_session(frames, cfg, hdr_bits)
    for i, (g, w) in enumerate(zip(got, want)):
        for a, b in zip((g[0], g[1], *g[2], *g[3:]), (w[0], w[1], *w[2], *w[3:])):
            assert torch.equal(a, b), f"frame {i}"
    assert [s["idr"] for s in enc.stats] == [True, False, False, True, False]
    assert enc.stats[4]["mb_types"] == torch.bincount(want[4][4], minlength=7).tolist()


def test_warm_up_leaves_the_state_as_it_was(clip):
    """The warm-up before a capture runs the body once for real: the
    session's P frame program then puts back the state it updated in
    place (the replay after the capture is the frame's one run), and the
    next frame equals a fresh encoder's."""
    cfg = EncoderConfig(qp=QP, intra_every=8, deblock=True)
    enc, fresh = (Encoder(W, H, cfg, device="cpu") for _ in range(2))
    for e in (enc, fresh):
        e.encode_sequence(clip[:2])
    prog = [p for key, p in enc._programs.items() if key[0] == "p"][0]
    state = {k: v.clone() for k, v in prog.slots.items()}
    prog._warm_up()
    for k, v in prog.slots.items():
        assert torch.equal(v, state[k]), k
    assert enc.encode_frame(*clip[2]) == fresh.encode_frame(*clip[2])
    assert torch.equal(enc._ref[0], fresh._ref[0]) and torch.equal(enc._mv, fresh._mv)


def test_two_lanes_hold_two_instances(clip):
    """Two lanes of one device get two instances of one program, and two
    lanes encode the same stream as one (each lane's program called on
    its own share)."""
    enc = GopIpppEncoder(W, H, QP, gop_len=2, devices=["cpu", "cpu"])
    a, b = (enc._program(lane, 2) for lane in enc.lanes)
    assert a is not b and a.slots["ys"] is not b.slots["ys"]
    two = enc.encode_sequence(clip[:8])
    one = GopIpppEncoder(W, H, QP, gop_len=2, device="cpu").encode_sequence(clip[:8])
    assert two == one
    assert all(len(lane.programs) == 1 for lane in enc.lanes)


def test_key_separates_qp_size_and_gop_length():
    """One lane's cache: the same key gives the same program; another QP,
    frame size or GOP length another one; the frame programs are keyed by
    mode too. A lane keeps GOP_PROGRAMS GOP programs: a new length past
    them drops the least recently used one."""
    lane = Lane(CPU)

    def gop(w, h, qp, n):
        return GopIpppEncoder(w, h, qp, gop_len=4, device="cpu")._program(lane, n)

    base = gop(W, H, 28, 4)
    assert gop(W, H, 28, 4) is base
    others = [gop(W, H, 30, 4), gop(64, 48, 28, 4), gop(W, H, 28, 3)]
    assert len({id(p) for p in [base, *others]}) == 4
    assert tuple(others[1].slots["ys"].shape) == (4, 48, 64)
    assert tuple(others[2].slots["ys"].shape) == (3, H, W)
    frames = [GopIntraEncoder(w, h, qp, mode=m, device="cpu")._program(lane)
              for w, h, qp, m in ((W, H, 28, "i16"), (W, H, 30, "i16"), (64, 48, 28, "i16"),
                                  (W, H, 28, "mixed"))]
    assert len({id(p) for p in frames}) == 4 and len(lane.programs) == 8

    enc, lane = GopIpppEncoder(W, H, QP, gop_len=GOP_PROGRAMS + 1, device="cpu"), Lane(CPU)
    progs = {n: enc._program(lane, n) for n in range(1, GOP_PROGRAMS + 1)}
    assert enc._program(lane, 1) is progs[1]  # 1 now the most recently used
    enc._program(lane, GOP_PROGRAMS + 1)  # drops 2, the least recently used
    assert len(lane.programs) == GOP_PROGRAMS
    assert enc._program(lane, 1) is progs[1] and enc._program(lane, 2) is not progs[2]


def test_cuda_program_without_a_card_raises():
    """A program asked for on CUDA without a card raises, from the encoders
    and from DeviceProgram's slots; nothing runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA route runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        GopIpppEncoder(W, H, QP, gop_len=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(W, H, EncoderConfig(qp=QP))
    with pytest.raises((RuntimeError, AssertionError)):
        DeviceProgram(lambda y: {"y": y}, {"y": planes((16, 16), "cuda")})
