"""K10's wrappers and the slice entropy's routing (the port's CAVLC symbols,
bit packing and I16 slice entropy against the JAX package are in
tests/test_torch_entropy_jax.py). The public slice entropies and
chroma_setup route a CPU tensor to their plain twins with no K10 launch
and refuse other devices; K10's table buffer holds the tables at
csrc/cavlc.cuh's offsets; its wrappers refuse inputs of a wrong shape or
dtype before anything launches, and pass the rest in the slots of the C
entry point's struct; the mixed form, on both routes, takes the chroma
setup and refuses a call without it."""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from h264_fer_tpu_torch.codec import entropy
from h264_fer_tpu_torch.kernels import build, cavlc_slice, wavefront_mixed
from h264_fer_tpu_torch.ops.device import const

torch.set_num_threads(1)

FORMS = ("i16", "mixed", "p", "chroma")
PUBLIC = {"i16": (entropy.i16_slice_entropy, entropy.i16_slice_entropy_plain,
                  cavlc_slice.i16_entropy),
          "mixed": (entropy.mixed_slice_entropy, entropy.mixed_slice_entropy_plain,
                    cavlc_slice.mixed_entropy),
          "p": (entropy.p_slice_entropy, entropy.p_slice_entropy_plain, cavlc_slice.p_entropy),
          "chroma": (entropy.chroma_setup, entropy.chroma_setup_plain,
                     cavlc_slice.chroma_entropy)}
WMB, HMB = 4, 3


def _args(form, seed=5):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in chip_smoke.k10_random_args(form, WMB, HMB, rng))


@pytest.mark.parametrize("form,other_chroma", [(f, False) for f in FORMS] + [("mixed", True)])
def test_cpu_tensors_route_to_the_plain_twin(form, other_chroma):
    """A CPU tensor takes the plain twin, launching nothing; every key of
    the result is the twin's (chroma_setup: its cbp_chroma, tc_chroma and
    bits), and the words have the length K10 allocates. The mixed form
    takes the chroma setup as K10 does: a setup of other chroma levels
    changes its words, and the result is the twin's fed that setup."""
    fn, plain, wrapper = PUBLIC[form]
    args = _args(form)
    kw = {"chroma": _chroma(form, seed=6 if other_chroma else 5)} if form == "mixed" else {}
    launches = [w.launches for _, _, w in PUBLIC.values()]
    got = fn(*args, WMB, HMB, **kw)
    want = plain(*args, WMB, HMB, **kw)
    assert [w.launches for _, _, w in PUBLIC.values()] == launches
    if form == "chroma":
        assert tuple(got) == entropy.CHROMA_KEYS
    else:
        assert set(got) == set(want)
        assert got["words"].shape == (cavlc_slice.n_words(form, WMB * HMB),)
        assert tuple(want) == ("words", "nbits", *cavlc_slice.KEYS[form])
    for key in got:
        assert torch.equal(got[key], want[key]), key
    if other_chroma:
        own = fn(*args, WMB, HMB, chroma=_chroma(form))
        assert not torch.equal(got["words"], own["words"])
        for key in ("cbp_chroma", "tc_chroma"):
            assert torch.equal(got[key], kw["chroma"][key]), key


@pytest.mark.parametrize("form", FORMS)
def test_meta_tensors_raise(form):
    fn = PUBLIC[form][0]
    args = tuple(a.to("meta") for a in _args(form))
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*args, WMB, HMB)


@pytest.mark.parametrize("part", range(len(cavlc_slice.TABLE_PARTS)))
def test_table_buffer_holds_each_table_at_its_header_offset(part):
    """The buffer K10 reads (uploaded through ops/device.const, read back)
    holds each table at the offset csrc/cavlc.cuh names; K6 reads the first
    kK6TabLen entries, its own TABLES."""
    name, table = cavlc_slice.TABLE_PARTS[part]
    header = (build.CSRC / "cavlc.cuh").read_text()
    offsets = {m[0]: int(m[1]) for m in re.findall(r"constexpr int k(\w+) = (\d+);", header)}
    buf = const(cavlc_slice.TABLES, "cpu").numpy()
    assert offsets["TabLen"] == buf.size
    assert offsets[name] == cavlc_slice.OFFSETS[name]
    start = offsets[name]
    np.testing.assert_array_equal(buf[start: start + np.size(table)],
                                  np.asarray(table).reshape(-1))
    k6 = wavefront_mixed.TABLES
    assert offsets["K6TabLen"] == k6.size
    np.testing.assert_array_equal(buf[: k6.size], k6)


def _chroma(form, seed=5):
    """The chroma setup (CPU, plain) of the chroma levels of the form's
    random arguments made from `seed`."""
    return entropy.chroma_setup(*_args(form, seed)[-2:], WMB, HMB)


def _bad(form, kind):
    """The form's arguments with its first level array given a wrong shape
    or dtype."""
    args = list(_args(form))
    i = chip_smoke.K10_LEVELS[form][0]
    args[i] = args[i][:, :-1] if kind == "shape" else args[i].to(torch.int64)
    return args


@pytest.mark.parametrize("kind", ["shape", "dtype", "good"])
@pytest.mark.parametrize("form", FORMS)
def test_wrapper_checks_its_inputs_before_launching(monkeypatch, form, kind):
    """With the device test and the launch stubbed, so that CPU tensors get
    as far as the launch: a wrong shape or dtype raises ValueError and
    launches nothing; good inputs make one call of the C entry point with
    one int64 slot per ARGS name (the fields of csrc/cavlc_slice.cu's
    struct Args, in order): the inputs' data pointers, the workspace's, the
    grid."""
    calls = []
    monkeypatch.setattr(cavlc_slice, "_device", lambda t: t.device)
    monkeypatch.setattr(build, "launch", lambda *a: calls.append(a))
    wrapper = PUBLIC[form][2]
    kw = {"chroma": _chroma(form)} if form == "mixed" else {}
    if kind != "good":
        with pytest.raises(ValueError, match="expected contiguous"):
            wrapper(*_bad(form, kind), WMB, HMB, **kw)
        assert not calls
        return
    args = _args(form)
    out = wrapper(*args, WMB, HMB, **kw)
    assert len(calls) == 1
    (_, name, symbol, vals, _) = calls[0]
    assert (name, symbol) == ("cavlc_slice", "cavlc_slice")
    assert vals[0] == cavlc_slice.FORMS[form] and vals[2] == len(cavlc_slice.ARGS)
    source = (build.CSRC / "cavlc_slice.cu").read_text()
    struct = source[source.index("struct Args {"): source.index("};", source.index("struct Args {"))]
    fields = re.findall(r"(\w+)(?:, (\w+))?(?:, (\w+))?;", struct)
    assert [f for group in fields for f in group if f] == list(cavlc_slice.ARGS)
    named = dict(zip(cavlc_slice.ARGS, vals[1].tolist()))
    assert named["nmb"] == WMB * HMB and named["wmb"] == WMB
    for i in chip_smoke.K10_LEVELS[form]:
        assert args[i].data_ptr() in vals[1].tolist()
    assert named["cdc"] == args[-2].data_ptr()
    assert named["tabs"] == const(cavlc_slice.TABLES, "cpu").data_ptr()
    nt = cavlc_slice.tickets(WMB * HMB)
    nw = 0 if form == "chroma" else cavlc_slice.n_words(form, WMB * HMB) + 1
    assert named["nwords"] == nw
    ndesc = 0 if form == "chroma" else cavlc_slice.DESC_WORDS * nt
    assert named["sync"] - named["words"] == 8 * (nw + 1 + ndesc)
    # the entry point zeroes the words, nbits, descriptors and flags, not the state
    assert named["zeroed"] == named["words"]
    assert named["zeroed_bytes"] == 8 * (nw + 1 + ndesc + (nt + 2) // 2)
    for key in cavlc_slice.STATE[form]:
        state = out["bits" if key == "mb_bits" else key]
        assert state.data_ptr() >= named["zeroed"] + named["zeroed_bytes"], key
    if form != "chroma":
        assert tuple(out) == ("words", "nbits", *cavlc_slice.KEYS[form])
        assert named["words"] == out["words"].data_ptr()
        assert named["nbits"] == out["nbits"].data_ptr() == named["words"] + 8 * nw


@pytest.mark.parametrize("route", ["kernel", "twin", "dispatcher"])
def test_mixed_wrapper_requires_the_chroma_setup(monkeypatch, route):
    """The mixed form computes no chroma setup of its own: without `chroma`
    K10's wrapper, the plain twin and the dispatcher raise ValueError, and
    nothing launches."""
    calls = []
    monkeypatch.setattr(cavlc_slice, "_device", lambda t: t.device)
    monkeypatch.setattr(build, "launch", lambda *a: calls.append(a))
    fn = {"kernel": cavlc_slice.mixed_entropy, "twin": entropy.mixed_slice_entropy_plain,
          "dispatcher": entropy.mixed_slice_entropy}[route]
    with pytest.raises(ValueError, match="chroma setup"):
        fn(*_args("mixed"), WMB, HMB)
    assert not calls
